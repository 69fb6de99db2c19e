"""Port parity: the Pallas-emission build (``GSCREAM_EMIT=pallas``) —
plain K9a (EXPAND1), plain K9b (EXPAND2), plain K8 (the column pack) and
``bin_instances_pallas`` — against the JAX package's
``bin_instances_pallas(interpret=True)``, fed the same JAX ``Splats``, at
a capacity that fits and at one whose row table overflows.

The JAX reference is one compiled program per capacity: the body of the
jitted ``bin_instances_pallas`` traced with a spy on ``_run_expand``, so
that EXPAND1's row table and EXPAND2's instance table come out beside
the binning, then ``pack_columns`` on its ``cols16``.  The port's tables
come from spies on its own wrappers.

Tolerances: every index field and every attribute bit-equal, except the
power coefficients k0..k2 (record lanes 6-8), which the JAX test of the
same build holds to rtol 1e-5, atol 1e-6 (XLA may contract their
multiply-adds; ``tests/test_emission.py:65-69``).  The port's records
are held bit-equal to its own ``pack_instance_data``, lanes 6-8 too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (TH, TW, gaussian_scene, jax_splats,
                                     to_torch, torch_splats)

W, H = 160, 96
CAPS = (2048, 1024)            # fits; its row table (512 rows) overflows
EXACT = [0, 1, 2, 3, 4, 5, 9, 10, 11, 12, 13]


def _spy(mp, mod, name, outs):
    fn = getattr(mod, name)

    def spy(*a, **k):
        out = fn(*a, **k)
        outs.append(out)
        return out
    mp.setattr(mod, name, spy)


@pytest.fixture(scope="module")
def case():
    from gscream_tpu.ops import emission as jem
    from gscream_tpu.ops.shuffle import pack_columns as jpack
    from gscream_tpu_torch.ops import binning as bn
    scene = gaussian_scene(1, thin=False)
    _, _, _, colors, op, unc = scene
    s = jax_splats(scene, W, H)
    ts = torch_splats(s)
    out = {}
    for cap in CAPS:
        jtabs, tabs = [], []
        with pytest.MonkeyPatch.context() as mp:
            _spy(mp, jem, "_run_expand", jtabs)

            @jax.jit
            def reference(s, op, colors, unc):
                jtabs.clear()
                b = jem.bin_instances_pallas.__wrapped__(
                    s, op, colors, unc, cap, W, H, TW, TH, interpret=True)
                return b, jtabs[0], jtabs[1], jpack(b.cols16, interpret=True)
            jb, rows16, inst16, packed = jax.tree.map(
                np.asarray, reference(s, jnp.asarray(op),
                                      jnp.asarray(colors),
                                      jnp.asarray(unc)))
            _spy(mp, bn, "expand1", tabs)
            _spy(mp, bn, "expand2", tabs)
            b = bn.bin_instances_pallas(ts, to_torch(op), to_torch(colors),
                                        to_torch(unc), cap, W, H, TW, TH)
        out[cap] = dict(jb=jb, rows16=rows16, inst16=inst16, packed=packed,
                        b=b, k9a=tabs[0], k9b=tabs[1])
    out["inputs"] = (ts, to_torch(op), to_torch(colors), to_torch(unc))
    return out


@pytest.mark.timeout(120)
@pytest.mark.parametrize("cap", CAPS)
def test_expand1_matches_jax(case, cap):
    """K9a plain against EXPAND1: the int32 [gid, ty, txmin, w_row] and
    the 11 attribute rows, bit-equal over every row slot."""
    c = case[cap]
    idx, attr = (t.numpy() for t in c["k9a"])
    ref = c["rows16"]
    assert ref.shape == (16, idx.shape[1])
    np.testing.assert_array_equal(idx, ref[:4].astype(np.int32))
    np.testing.assert_array_equal(attr, ref[4:15])
    assert not ref[15].any() and (idx[3] > 0).sum() > 100


@pytest.mark.timeout(120)
@pytest.mark.parametrize("cap", CAPS)
def test_expand2_matches_jax(case, cap):
    """K9b plain against EXPAND2 over every instance slot: the int32
    [tile, gid] and the records, k0..k2 within the JAX test's tolerance."""
    c = case[cap]
    rec, ids = (t.numpy() for t in c["k9b"])
    ref = c["inst16"]
    np.testing.assert_array_equal(ids, ref[14:16].astype(np.int32))
    np.testing.assert_array_equal(rec[EXACT], ref[EXACT])
    np.testing.assert_allclose(rec[6:9], ref[6:9], rtol=1e-5, atol=1e-6)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("cap", CAPS)
def test_bin_instances_pallas_matches_jax(case, cap):
    """Every index field bit-equal (``gauss_id``/``emit_slot`` over the
    live prefix), the demand counts equal, ``cols16`` as the records."""
    from gscream_tpu.ops.binning import overflow_demand as jdemand
    from gscream_tpu_torch.ops.binning import overflow_demand
    c = case[cap]
    a, b = c["jb"], c["b"]
    n = min(int(a.num_instances), cap)
    for f in ("num_instances", "num_rows", "tile_id", "tile_start",
              "tile_count", "offsets"):
        np.testing.assert_array_equal(getattr(b, f).numpy(), getattr(a, f),
                                      err_msg=f)
        assert getattr(b, f).dtype == torch.int32, f
    for f in ("gauss_id", "emit_slot"):
        np.testing.assert_array_equal(getattr(b, f).numpy()[:n],
                                      getattr(a, f)[:n], err_msg=f)
    demand = int(overflow_demand(b))
    assert demand == int(jdemand(a))
    assert (demand > cap) == (cap == min(CAPS)) and n > 0
    cols = b.cols16.numpy()
    np.testing.assert_array_equal(cols[EXACT + [14, 15]],
                                  a.cols16[EXACT + [14, 15]])
    np.testing.assert_allclose(cols[6:9], a.cols16[6:9], rtol=1e-5,
                               atol=1e-6)
    assert not cols[:, n:].any()


@pytest.mark.timeout(120)
def test_pack_columns_bit_equal(case):
    """K8 plain against ``pack_columns`` on JAX's ``cols16``."""
    from gscream_tpu_torch.ops.shuffle import pack_columns
    c = case[max(CAPS)]
    got = pack_columns(to_torch(c["jb"].cols16)).numpy()
    np.testing.assert_array_equal(got, c["packed"].reshape(-1, 16))
    assert np.abs(got[:, 6]).max() > 0


@pytest.mark.timeout(120)
@pytest.mark.parametrize("cap", CAPS)
def test_records_match_the_xla_build(case, cap):
    """The port's own two routes: the Pallas build's index fields equal
    ``bin_instances``', and K8 on its ``cols16`` equals
    ``pack_instance_data`` on the XLA build, every lane bit-equal over
    the live instances."""
    from gscream_tpu_torch.ops.binning import bin_instances
    from gscream_tpu_torch.ops.rasterize_tiled import pack_instance_data
    ts, op, colors, unc = case["inputs"]
    b = case[cap]["b"]
    a = bin_instances(ts, cap, W, H, TW, TH)
    n = min(int(a.num_instances), cap)
    for f in ("num_instances", "num_rows", "tile_id", "tile_start",
              "tile_count", "offsets"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for f in ("gauss_id", "emit_slot"):
        assert torch.equal(getattr(a, f)[:n], getattr(b, f)[:n]), f
    args = (ts.mean2d, ts.conic, op, colors, ts.depth, unc)
    gx = -(-W // TW)
    assert torch.equal(pack_instance_data(*args, b, gx)[:n],
                       pack_instance_data(*args, a, gx)[:n])


def test_expand2_rounds_half_to_even():
    """sx, sy round the centre half to even, as ``jnp.round`` does."""
    from gscream_tpu_torch.ops.emission import expand2
    centres = np.array([[40.5, 41.5], [-2.5, 7.5], [33.25, 64.75]],
                       np.float32)
    rf = np.zeros((11, 3), np.float32)
    rf[0:2] = centres.T
    rf[2], rf[4] = 0.5, 0.5
    io = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    ri = torch.tensor([[0, 1, 2], [1, 2, 0], [1, 0, 2]], dtype=torch.int32)
    rec, ids = expand2(io, ri, to_torch(rf), 256, TW, TH, 4, 12)
    ox = np.array([1, 0, 2], np.float32) * TW
    oy = np.array([1, 2, 0], np.float32) * TH
    np.testing.assert_array_equal(
        rec[12:14, :3].numpy(),
        np.stack([ox, oy]) - np.asarray(jnp.round(jnp.asarray(centres.T))))
    np.testing.assert_array_equal(rec[12:14, :3].numpy(),
                                  [[32 - 40, 0 + 2, 64 - 33],
                                   [32 - 42, 64 - 8, 0 - 65]])
    assert ids[:, :3].tolist() == [[5, 8, 2], [0, 1, 2]]
    assert (ids[0, 3:] == 12).all() and not rec[:, 3:].any()


@pytest.mark.timeout(120)
def test_build_binning_selector(case, monkeypatch):
    """``GSCREAM_EMIT=pallas`` takes the Pallas build only where the JAX
    selector does (rasterize_tiled.py:1278-1292): at capacities that are
    multiples of 1024, with the precise sort, legacy records, ``t_iso``,
    row-tight emission and the lexicographic sort.  Under each other
    switch it takes the XLA build, ``cols16`` ``None``, as JAX does."""
    from gscream_tpu_torch.ops.rasterize_tiled import build_binning
    ts, op, colors, unc = case["inputs"]

    def route(cap, splats=ts, precise=True):
        return build_binning(splats, op, colors, unc, cap, W, H,
                             precise).cols16
    for var in ("GSCREAM_EMIT", "GSCREAM_KERNEL_COEFF", "GSCREAM_ROW_TIGHT",
                "GSCREAM_SORT_FUSED", "GSCREAM_MXU_POWER"):
        monkeypatch.delenv(var, raising=False)
    assert route(2048) is None
    monkeypatch.setenv("GSCREAM_EMIT", "pallas")
    assert route(2048).shape == (16, 2048)
    assert route(1536) is None              # not a multiple of 1024
    for var, val in (("GSCREAM_KERNEL_COEFF", "1"),
                     ("GSCREAM_ROW_TIGHT", "0"), ("GSCREAM_SORT_FUSED", "1")):
        with monkeypatch.context() as m:
            m.setenv(var, val)
            assert route(2048) is None, var
    assert route(2048, precise=False) is None
    assert route(2048, splats=ts._replace(t_iso=None)) is None
    with monkeypatch.context() as m:
        # JAX refuses raw records with the TPU's MXU power contraction
        m.setenv("GSCREAM_KERNEL_COEFF", "1")
        m.setenv("GSCREAM_MXU_POWER", "1")
        with pytest.raises(RuntimeError, match="MXU_POWER"):
            route(2048)
