"""Port parity: the row modes of the gradient reduction
(``GSCREAM_REORDER=gather|scatter|sort``, plain K7), the sanitize of the
default cm flow, and the training slice of the Pallas-emission
configuration, against the JAX package on the CPU (Pallas in interpret
mode).

K2's rows come from the port's plain K2 on a seeded scene of 300
gaussians at 64×32 with random pixel rows; the JAX reference is one
compiled program holding ``segment_reduce_grads`` in each mode (the mode
is read at trace time) and ``reduce_grads_cm`` on the same rows with a
NaN, a +inf and a -inf planted in live slots.

The slice: one port ``train_step`` under ``GSCREAM_EMIT=pallas
GSCREAM_REORDER=gather`` against JAX's ``train_step`` under the same
environment (reference view), from the state of
``tests/test_torch_train_step.py`` with its tolerances.  JAX reads the
selectors when it traces, and its ``train_step`` is one module-level
``jax.jit`` whose cache other files fill on the default route, so the
reference traces the same function under a ``jax.jit`` of its own, which
shares no cache with that one and leaves none behind, and spies prove
that both packages took the route.

Tolerances: K7 against the Pallas kernel rtol 1e-5, atol 1e-6 (the
Pallas kernel sums each block by indicator matmuls, the port in the
chunked order of ``gscream_tpu_torch/ops/rasterize_tiled.py``); the three
modes, the cm flow on finite rows and the port's two
routes bit-equal to each other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (TH, TW, gaussian_scene, jax_splats,
                                     to_torch, torch_splats)

W, H = 64, 32
CAP = 2048
MODES = ("gather", "scatter", "sort")
BAD = ((5, 3, np.nan), (17, 7, np.inf), (40, 10, -np.inf))


@pytest.fixture(scope="module")
def case():
    from gscream_tpu.ops import rasterize_tiled as jrt
    from gscream_tpu.ops.binning import Binning as JBinning
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.ops.binning import bin_instances
    scene = gaussian_scene(3, n=300, thin=False)
    _, _, _, colors, op, unc = scene
    s = torch_splats(jax_splats(scene, W, H))
    b = bin_instances(s, CAP, W, H, TW, TH)
    n_live = int(b.num_instances)
    assert 50 < n_live <= CAP
    inst = rt.pack_instance_data(s.mean2d, s.conic, to_torch(op),
                                 to_torch(colors), s.depth, to_torch(unc), b,
                                 W // TW)
    n_tiles = b.tile_start.shape[0]
    pix = np.random.default_rng(12).normal(size=(n_tiles, 8, rt.PIX))
    rows = rt.run_backward(inst, to_torch(pix.astype(np.float32)),
                           b.tile_start, b.tile_count, n_tiles)
    bad = rows.clone()
    for slot, lane, val in BAD:
        assert slot < n_live
        bad[slot, lane] = val
    jb = JBinning(*(jnp.asarray(getattr(b, f).numpy())
                    for f in JBinning._fields[:8]))
    n_gauss = s.mean2d.shape[0]
    with pytest.MonkeyPatch.context() as mp:
        @jax.jit
        def reference(rows, bad):
            out = {}
            for mode in MODES:
                mp.setenv("GSCREAM_REORDER", mode)
                out[mode] = jrt.segment_reduce_grads(rows, jb, n_gauss, True)
            out["cm"] = jrt.reduce_grads_cm(bad.reshape(-1, 128), jb,
                                            n_gauss, True)
            return out
        ref = jax.tree.map(np.asarray, reference(jnp.asarray(rows.numpy()),
                                                 jnp.asarray(bad.numpy())))
    return dict(b=b, rows=rows, bad=bad, ref=ref)


def _mode(monkeypatch, mode):
    monkeypatch.setenv("GSCREAM_REORDER", mode)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("mode", MODES)
def test_segment_reduce_grads_matches_jax(case, monkeypatch, mode):
    """Plain K7 after each reorder against ``segment_reduce_grads``."""
    from gscream_tpu_torch.ops.rasterize_tiled import segment_reduce_grads
    _mode(monkeypatch, mode)
    got = segment_reduce_grads(case["rows"], case["b"]).numpy()
    ref = case["ref"][mode]
    assert got.shape == ref.shape and np.abs(ref[:, 6]).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.timeout(120)
def test_reorder_modes_bit_equal(case, monkeypatch):
    """The three row modes, and the cm flow (K4, the column scatter, K3),
    give the same sums bit for bit: K3 and K7 share one summation order
    (32-instance chunks, a segmented scan inside each, the chunk partials
    left to right), which depends on the offsets alone."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    b = case["b"]
    sums = {}
    for mode in MODES:
        _mode(monkeypatch, mode)
        sums[mode] = rt.segment_reduce_grads(case["rows"], b)
    cm = rt.segment_reduce_cm(rt.emission_columns(case["rows"], b),
                              b.offsets)
    for mode in MODES:
        assert torch.equal(sums[mode], cm), mode


@pytest.mark.timeout(120)
def test_cm_flow_sanitizes_like_jax(case):
    """Non-finite K2 entries in live slots: without the sanitize the cm
    flow carries them into the per-gaussian sums (the fault); K4 zeroes
    them, so the port equals JAX's ``reduce_grads_cm``, which does too,
    and every sum is finite."""
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.ops.shuffle import unpack_columns
    b, bad = case["b"], case["bad"]
    cols = bad.T.contiguous()               # a transpose that keeps them
    raw = torch.empty_like(cols).index_copy_(1, b.emit_slot.long(), cols)
    assert not torch.isfinite(rt.segment_reduce_cm(raw, b.offsets)).all()
    assert torch.equal(unpack_columns(bad),
                       torch.where(torch.isfinite(cols), cols, 0.0))
    got = rt.segment_reduce_cm(rt.emission_columns(bad, b),
                               b.offsets).numpy()
    ref = case["ref"]["cm"]
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.timeout(120)
def test_row_modes_do_not_sanitize(case, monkeypatch):
    """As in the JAX package, only the cm flow zeroes non-finite rows."""
    from gscream_tpu_torch.ops.rasterize_tiled import segment_reduce_grads
    _mode(monkeypatch, "gather")
    assert not torch.isfinite(segment_reduce_grads(case["bad"],
                                                   case["b"])).all()


@pytest.mark.timeout(120)
def test_reduction_selectors_raise(case, monkeypatch):
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    _mode(monkeypatch, "rows")
    with pytest.raises(ValueError, match="GSCREAM_REORDER"):
        rt._reorder_mode()
    _mode(monkeypatch, "cm")
    with pytest.raises(ValueError, match="segment_reduce_cm"):
        rt.segment_reduce_grads(case["rows"], case["b"])
    # GSCREAM_SCATTER_REDUCE: JAX's segment_sum over gauss_id
    # (rasterize_tiled.py:1227-1231), which sums in another order than
    # the port's index_add_, hence rtol 1e-5
    monkeypatch.setenv("GSCREAM_SCATTER_REDUCE", "1")
    b, rows = case["b"], case["rows"]
    n = b.offsets.shape[0] - 1
    got = rt.per_gaussian_sums(rows, b).numpy()
    ref = np.asarray(jax.ops.segment_sum(
        jnp.asarray(rows.numpy()), jnp.asarray(b.gauss_id.numpy()),
        num_segments=n))
    assert np.abs(ref[:, 6]).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
    k3 = rt.segment_reduce_cm(rt.emission_columns(rows, b),
                              b.offsets).numpy()
    np.testing.assert_allclose(got, k3, rtol=1e-5,
                               atol=1e-6 * np.abs(k3).max())


@pytest.fixture(scope="module")
def slice_steps():
    """JAX's and the port's ``train_step`` under ``GSCREAM_EMIT=pallas
    GSCREAM_REORDER=gather`` (reference view), with the calls of each
    package's route counted; the port's step under the default route,
    from the same state."""
    import functools

    from gscream_tpu.cameras import make_camera as jmake
    from gscream_tpu.config import OptimConfig as JOpt
    from gscream_tpu.model.scaffold import ScaffoldConfig as JCfg
    from gscream_tpu.ops import emission as jem
    from gscream_tpu.ops import rasterize_tiled as jrt
    from gscream_tpu.train.step import train_step as jstep
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig
    from gscream_tpu_torch.ops import binning as bn
    from gscream_tpu_torch.ops import rasterize_tiled as rt
    from gscream_tpu_torch.train.state import train_state_from_numpy
    from gscream_tpu_torch.train.step import train_step
    from tests.test_torch_train_step import (CAP as SCAP, H as SH, KW,
                                             W as SW, _start_state,
                                             _targets)
    jcfg, cfg = JCfg(**KW), ScaffoldConfig(**KW)
    ts0 = _start_state(jcfg)
    R, T = np.eye(3), np.array([0.0, 0.0, 3.0])
    gt, mask, midas, fg_box = _targets()
    calls = {}

    def count(mp, mod, name, key):
        fn = getattr(mod, name)

        def spy(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)
        mp.setattr(mod, name, spy)

    def port_step():
        ts = train_state_from_numpy(ts0, cfg, device="cpu")
        cam = make_camera(R, T, 1.0, 1.0 * SH / SW, SW, SH, device="cpu")
        return train_step(
            ts, cam, to_torch(gt), to_torch(mask), to_torch(midas),
            to_torch(fg_box), cfg=cfg, opt=OptimConfig(), is_ref=True,
            capacity=SCAP, width=SW, height=SH, accumulate=True)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GSCREAM_EMIT", "pallas")
        mp.setenv("GSCREAM_REORDER", "gather")
        count(mp, jem, "bin_instances_pallas", "jax bin_instances_pallas")
        count(mp, jrt, "segment_reduce_grads", "jax segment_reduce_grads")
        # a jit of its own: it can neither reuse a trace of the default
        # route from the module-level ``train_step`` nor leave this one there
        own_step = jax.jit(functools.partial(jstep.__wrapped__),
                           static_argnames=("cfg", "opt", "is_ref",
                                            "use_crossattn", "capacity",
                                            "interpret", "width", "height",
                                            "accumulate"))
        jts, jaux = own_step(
            ts0, jmake(R, T, 1.0, 1.0 * SH / SW, SW, SH), jnp.asarray(gt),
            jnp.asarray(mask), jnp.asarray(midas), jnp.asarray(fg_box),
            jnp.zeros(4, jnp.int32), cfg=jcfg, opt=JOpt(), is_ref=True,
            use_crossattn=False, capacity=SCAP, interpret=True, width=SW,
            height=SH, accumulate=True)
        out["jax"] = train_state_from_numpy(jax.tree.map(np.asarray, jts),
                                            cfg, device="cpu")
        out["jaux"] = jax.tree.map(np.asarray, jaux)
        for mod, name in ((bn, "expand1"), (bn, "expand2"),
                          (rt, "pack_columns"), (rt, "segment_reduce_rows"),
                          (rt, "segment_reduce_cm"),
                          (rt, "unpack_columns")):
            count(mp, mod, name, f"port {name}")
        out["port"], out["aux"] = port_step()
        out["calls"] = dict(calls)
    out["default"] = port_step()[0]
    return out


@pytest.mark.timeout(180)
def test_train_step_pallas_route_matches_jax(slice_steps):
    from tests.test_torch_train_step import CAP as SCAP, _close
    r = slice_steps
    assert r["calls"] == {
        "jax bin_instances_pallas": 1, "jax segment_reduce_grads": 1,
        "port expand1": 1, "port expand2": 1, "port pack_columns": 1,
        "port segment_reduce_rows": 1}, r["calls"]
    np.testing.assert_allclose(float(r["aux"].loss), float(r["jaux"].loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(r["aux"].l1), float(r["jaux"].l1),
                               rtol=1e-5)
    assert int(r["aux"].num_instances) == int(r["jaux"].num_instances) \
        <= SCAP
    assert int(r["aux"].n_active) == int(r["jaux"].n_active)
    worst = {}
    for name, ref in r["jax"].m.items():
        got = r["port"].m[name]
        if not ref.any():
            np.testing.assert_array_equal(got.numpy(), ref.numpy(), name)
            continue
        worst[name] = _close(got, ref, f"m {name}")
        _close(r["port"].v[name], r["jax"].v[name], f"v {name}")
    assert len(worst) >= 10, sorted(worst)
    print(f"worst |Δm| / scale per leaf {worst}")


@pytest.mark.timeout(180)
def test_port_routes_bit_equal(slice_steps):
    """The port's step under the Pallas-emission route equals its
    default-route step (XLA build, cm flow) bit for bit."""
    from gscream_tpu_torch.train.state import named_params
    got, ref = slice_steps["port"], slice_steps["default"]
    for name, m in ref.m.items():
        assert torch.equal(got.m[name], m), name
        assert torch.equal(got.v[name], ref.v[name]), name
    for (name, p), q in zip(named_params(got.scaffold).items(),
                            named_params(ref.scaffold).values()):
        assert torch.equal(p, q), name
