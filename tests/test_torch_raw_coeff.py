"""Port parity: the raw-coefficient mode of K1 and K2
(``GSCREAM_KERNEL_COEFF=1``) — the raw pack, the plain raw K1 and K2,
the band path with ``tile_base`` and the ``rasterize_tiled`` VJP —
against the JAX package in Pallas interpret mode, and against the port's
own legacy mode, on one seeded scene of 300 overlapping gaussians at
96×64 (3×2 tiles) with the JAX ``Binning``.

JAX reads ``KERNEL_COEFF`` once, at import (rasterize_tiled.py:117), so
the reference patches the module attribute for the span of its trace: a
``jax.jit`` of its own, the custom_vjp's forward rule and
``_raster_bwd``'s steps written out, as ``tests/test_torch_raster_bwd.py``
does for the legacy mode.  JAX's packed lanes 6-10 are held to hold
``(mx, my, ca, cb, cc)``, so the reference did trace the raw mode.

Tolerances:
* the raw pack: bit-equal (a gather);
* K1: 1e-4 absolute on every output row, except at pixels where the
  ``T < 1e-4`` stop moves by one instance, at most 0.1% of them
  (``tests/test_torch_rasterize_fwd.py``);
* K2 and the VJP: the flip-aware bound of
  ``tests/test_rasterize_tiled.py`` (``tests/test_torch_raster_bwd.py``);
* the port's raw mode against its legacy mode, the bands against the
  whole frame: bit-equal.  Both modes derive the coefficients with the
  same float32 operations, one rounding each, in the same order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (TH, TW, assert_close_flip_aware,
                                     gaussian_scene, jax_splats, to_torch,
                                     torch_binning)

W, H = 96, 64
GX = W // TW
CAP = 1 << 13
N_TILES = (W // TW) * (H // TH)


@pytest.fixture(scope="module")
def case():
    from gscream_tpu.ops import rasterize_tiled as jrt
    from gscream_tpu.ops.binning import bin_instances as jbin
    from gscream_tpu.ops.shuffle import unpack_columns
    scene = gaussian_scene(5, n=300, thin=False)
    s = jax_splats(scene, W, H)
    b = jbin(s, CAP, W, H, TW, TH, expand="xla")
    assert int(b.num_instances) <= CAP
    _, _, _, colors, op, unc = scene
    args = (s.mean2d, s.conic, jnp.asarray(op), jnp.asarray(colors),
            s.depth, jnp.asarray(unc), jnp.asarray([0.1, 0.2, 0.3]))
    rng = np.random.default_rng(21)
    cot = jrt.TiledOut(*(jnp.asarray(rng.normal(size=sh), jnp.float32)
                         for sh in ((H, W, 3), (H, W), (H, W), (H, W))))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrt, "KERNEL_COEFF", True)

        @jax.jit
        def reference(args, cot):
            out, res = jrt._raster_fwd(*args[:6], b, args[6], W, H, True)
            inst, _, bg, raw_c, d_img, u_img, t_img, mean2d, conic, op = res
            tiles = jrt._run_forward(inst, b.tile_start, b.tile_count,
                                     N_TILES, True, GX)
            gc = cot.color.transpose(2, 0, 1)
            gtt = (jnp.einsum('c,chw->hw', bg, gc) + cot.final_t) * t_img
            total = (jnp.einsum('chw,chw->hw', raw_c, gc)
                     + d_img * cot.depth + u_img * cot.uncertainty)
            pix = jnp.stack([gc[0], gc[1], gc[2], cot.depth,
                             cot.uncertainty, total, gtt,
                             jnp.zeros_like(t_img)])
            pix_tiles = jrt.image_to_tiles(pix, W, H)
            raw = jrt._run_backward(inst, pix_tiles, b.tile_start,
                                    b.tile_count, N_TILES, True, GX)
            # reduce_grads_cm (:1044-1084), as tests/test_torch_raster_bwd
            rows = jnp.where(jnp.isfinite(raw), raw, 0.0)
            cols = unpack_columns(rows, True)
            ge = jnp.zeros((16, CAP), jnp.float32).at[1:12, b.emit_slot].set(
                cols[1:12, :CAP])
            pg = jrt.segment_reduce_cm(ge, b.offsets, s.mean2d.shape[0],
                                       True)
            grads = jrt.pergauss_chain(pg, mean2d, conic, op) + (
                jnp.einsum('hw,chw->c', t_img, gc),)
            return out, grads, inst, tiles, pix_tiles, raw

        out, grads, *rest = reference(args, cot)
    inst, tiles, pix_tiles, raw = map(np.asarray, rest)
    return dict(args=args, b=b, cot=cot, out=out, grads=grads,
                inst=inst.reshape(-1, 16)[:CAP], tiles=tiles,
                pix_tiles=pix_tiles, rows=raw.reshape(-1, 16)[:CAP])


def _torch_args(case):
    return [to_torch(a) for a in case["args"]]


def _packs(case):
    """The port's raw and legacy records of the case."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    a = _torch_args(case)[:6]
    tb = torch_binning(case["b"])
    return (rt.pack_instance_data(*a, tb, GX, raw=True),
            rt.pack_instance_data(*a, tb, GX), tb)


@pytest.mark.timeout(120)
def test_raw_pack_matches_jax(case):
    """The raw records are the attribute rows padded to 16 lanes, bit for
    bit; lanes 6-10 hold each slot's gaussian's (mx, my, ca, cb, cc)."""
    raw, _, tb = _packs(case)
    ref = case["inst"]
    np.testing.assert_array_equal(raw.numpy(), ref)
    gid = tb.gauss_id.numpy()
    m, c = (np.asarray(x) for x in case["args"][:2])
    np.testing.assert_array_equal(ref[:, 6:8], m[gid])
    np.testing.assert_array_equal(ref[:, 8:11], c[gid])
    assert not ref[:, 11:].any()


@pytest.mark.timeout(120)
def test_raw_forward_matches_jax(case):
    """Plain raw K1 against ``_run_forward`` in raw mode."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    raw, _, tb = _packs(case)
    got = rt.run_forward_raw(raw, tb.tile_start, tb.tile_count, N_TILES, GX)
    ref = case["tiles"]
    assert float(ref[:, 6].mean()) < 0.9                # non-trivial cover
    err = np.abs(got.numpy() - ref)[:, 1:7].max(1)      # (tiles, PIX)
    assert (err > 1e-4).sum() <= 1e-3 * N_TILES * rt.PIX, float(err.max())


@pytest.mark.timeout(120)
def test_raw_backward_matches_jax(case):
    """Plain raw K2 against ``_run_backward`` in raw mode on the same
    records and pixel rows; the slots past the live instances are zero in
    both."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    raw, _, tb = _packs(case)
    got = rt.run_backward_raw(raw, to_torch(case["pix_tiles"]),
                              tb.tile_start, tb.tile_count, N_TILES,
                              GX).numpy()
    ref = case["rows"]
    n = int(tb.num_instances)
    assert np.abs(ref[:n, 6]).max() > 0
    for lane in range(1, 12):
        assert_close_flip_aware(got[:, lane], ref[:, lane], f"lane {lane}")
    assert not got[n:].any() and not ref[n:].any()


@pytest.mark.timeout(120)
def test_raw_equals_legacy(case):
    """The port's raw K1 and K2 on raw records are bit-equal to its legacy
    K1 and K2 on the legacy records of the same binning."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    raw, legacy, tb = _packs(case)
    ts, tc = tb.tile_start, tb.tile_count
    assert torch.equal(rt.run_forward_raw(raw, ts, tc, N_TILES, GX),
                       rt.run_forward(legacy, ts, tc, N_TILES))
    pix = to_torch(case["pix_tiles"])
    assert torch.equal(rt.run_backward_raw(raw, pix, ts, tc, N_TILES, GX),
                       rt.run_backward(legacy, pix, ts, tc, N_TILES))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("n_bands", [2, 3])
def test_raw_bands_stitch(case, n_bands):
    """Raw K1 and K2 per band of tile rows, each with its first global
    tile as ``tile_base`` (``parallel/shard.py``; 3 bands pad the grid):
    the stitched K1 bands are bit-equal to the whole frame and empty on
    the pad tiles; each band's K2 rows are bit-equal to the whole frame's
    in the band's slots and zero outside them."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.parallel.shard import (_band_geometry,
                                                  _band_slices, pad_tiles)
    raw, _, tb = _packs(case)
    pix = to_torch(case["pix_tiles"])
    full_k1 = rt.run_forward_raw(raw, tb.tile_start, tb.tile_count, N_TILES,
                                 GX)
    full_k2 = rt.run_backward_raw(raw, pix, tb.tile_start, tb.tile_count,
                                  N_TILES, GX)
    gx, gy, gy_pad, rows = _band_geometry(W, H, n_bands)
    bb = pad_tiles(tb, W, H, n_bands)
    pix_pad = torch.cat([pix, pix.new_zeros(((gy_pad - gy) * gx,)
                                            + pix.shape[1:])])
    parts = []
    for band in range(n_bands):
        ts, tc, nl = _band_slices(bb, gx, rows, band)
        parts.append(rt.run_forward_raw(raw, ts, tc, nl, gx, band * nl))
        k2 = rt.run_backward_raw(raw, pix_pad[band * nl:(band + 1) * nl],
                                 ts, tc, nl, gx, band * nl)
        lo, hi = int(ts[0]), int(ts[-1] + tc[-1])
        assert torch.equal(k2[lo:hi], full_k2[lo:hi]), band
        assert not k2[:lo].any() and not k2[hi:].any(), band
    tiles = torch.cat(parts)
    assert torch.equal(tiles[:N_TILES], full_k1)
    assert bool((tiles[N_TILES:, 6] == 1).all())
    assert not tiles[N_TILES:, :6].any()


@pytest.mark.timeout(120)
def test_raw_rasterize_vjp(case, monkeypatch):
    """``rasterize_tiled`` under ``GSCREAM_KERNEL_COEFF=1``: the outputs
    and the gradients of all seven leaves against JAX's raw VJP, and bit
    for bit against the port's legacy mode."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    cot = [to_torch(c) for c in case["cot"]]
    tb = torch_binning(case["b"])

    def run():
        leaves = [a.requires_grad_() for a in _torch_args(case)]
        out = rt.rasterize_tiled(*leaves[:6], tb, leaves[6], W, H)
        torch.autograd.backward(list(out), cot)
        return [o.detach() for o in out], [x.grad for x in leaves]
    monkeypatch.setenv("GSCREAM_KERNEL_COEFF", "1")
    out_raw, g_raw = run()
    monkeypatch.setenv("GSCREAM_KERNEL_COEFF", "0")
    out_leg, g_leg = run()
    for a, b_ in zip(out_raw + g_raw, out_leg + g_leg):
        assert torch.equal(a, b_)
    names = ("mean2d", "conic", "opacity", "colors", "depth", "unc", "bg")
    for name, g, ref in zip(names, g_raw, case["grads"]):
        assert_close_flip_aware(g.numpy(), np.asarray(ref), name)
    err = np.abs(out_raw[0].numpy() - np.asarray(case["out"].color))
    assert (err.max(-1) > 1e-4).sum() <= 1e-3 * H * W


@pytest.mark.timeout(120)
def test_raw_shift_rounds_half_to_even(case):
    """Centres at exact .5 values: the raw records' shifts ``sx = ox −
    rint(mx)`` (half to even, as ``jnp.round`` and ``torch.round``) equal
    the legacy pack's and JAX's, and ``round(40.5)`` is 40."""
    from gscream_tpu.ops import rasterize_tiled as jrt
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    a = _torch_args(case)[:6]
    tb = torch_binning(case["b"])
    n_live = int(tb.num_instances)
    gid = tb.gauss_id[:n_live].long()
    picks = torch.unique(gid)[:8]
    halves = torch.tensor([40.5, 41.5, 2.5, 3.5, 63.5, 64.5, 0.5, 95.5])
    mean2d = a[0].clone()
    mean2d[picks, 0] = halves[:picks.numel()]
    mean2d[picks, 1] = halves.flip(0)[:picks.numel()]
    a[0] = mean2d
    raw = rt.pack_instance_data(*a, tb, GX, raw=True)
    legacy = rt.pack_instance_data(*a, tb, GX)
    ox, oy = rt.tile_origin(tb.tile_id[:n_live], GX)
    derived = rt.legacy_records(raw[:n_live], ox, oy)
    assert torch.equal(derived, legacy[:n_live])
    jargs = [jnp.asarray(x.numpy()) for x in a]
    jleg = np.asarray(jrt.pack_instance_data(*jargs, case["b"], GX)
                      ).reshape(-1, 16)[:n_live]
    np.testing.assert_array_equal(derived[:, 12:14].numpy(), jleg[:, 12:14])
    on_half = (mean2d[gid, 0] == 40.5)
    assert bool(on_half.any())
    np.testing.assert_array_equal(derived[on_half, 12].numpy(),
                                  ox[on_half].numpy() - 40.0)
