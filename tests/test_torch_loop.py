"""The training loop of the port (``train/loop.py::train_scene``) and its
synthetic data, on the CPU.

* ``make_scene`` (and the oracle ``rasterize_scan`` it renders with)
  against the JAX package's, rtol 1e-5.
* A loop parity run: both packages' ``train_scene`` for 24 iterations on
  the same 256×256 synthetic scene from the same initial model (the JAX
  loop's own, converted and saved as a port checkpoint at step 0), with a
  densification at iteration 12 and phase 2 from iteration 17, and JAX's
  random draws replayed into the port's two draw functions (the token
  priorities under the state's key chain, the keep draws under
  ``fold_in(PRNGKey(seed + 2), it)``).  At this size the reference's
  256-pixel token patch lands on the object in about half of the phase-2
  steps (on a 64-pixel image it almost never does).  Per-step losses
  within 1e-3 relative up to the densification and 1e-2 after it (the
  renders differ by float32 rounding, which the training amplifies);
  ``cross_ok`` equal at every step; the anchor count after the
  densification equal except for offsets whose mean gradient lies within
  1e-3 of a level's threshold, named when they matter.
* Kill and resume: 16 iterations straight against 8, a checkpoint, a
  restore and 8 more, with a densification and phase-2 steps on both
  sides of the cut: bit-equal.
* A forced overflow: a run started at capacity 2048 overflows in its
  first (phase-2) step and re-runs it at a raised tier; it is bit-equal
  to a run started at that tier.
* The pipeline: ``GSCREAM_PIPELINE=3`` against ``1`` over 10 iterations
  with an overflow re-run of the first step (re-launching the steps
  queued behind it), a densification, phase-2 steps and checkpoints:
  every state tensor, the generator, the losses, ``log.steps`` and
  ``log.events`` equal, and the state each callback sees equal at every
  iteration.
* The device-side write gate: a launched step whose demand exceeds its
  capacity, or whose loss is not finite, leaves every state tensor (and
  in phase 1 the generator) bit-equal to before.
"""
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_common import (  # noqa: F401
    to_torch, two_torch_threads)

SIZE = 256
SCENE = dict(n_views=3, n_gauss=200, width=SIZE, height=SIZE, seed=3)
MODEL = dict(feat_dim=8, n_offsets=2, voxel_size=0.1, anchor_capacity=512)
PARITY = dict(iterations=24, start_crossattn_from=16, start_stat=0,
              update_from=0, update_interval=12, update_until=25)
CAP = 1 << 14


def _run(optim, seed=3):
    from gscream_tpu_torch.config import ModelConfig, OptimConfig, RunConfig
    return RunConfig(model=ModelConfig(**MODEL),
                     optim=OptimConfig(**optim), seed=seed)


@pytest.fixture(scope="module")
def scene():
    from gscream_tpu_torch.data.synthetic import make_scene
    return make_scene(device="cpu", **SCENE)


def _quiet_logger():
    import logging
    lg = logging.getLogger("test_torch_loop")
    lg.propagate = False
    lg.handlers[:] = [logging.NullHandler()]
    return lg


@pytest.mark.timeout(120)
def test_make_scene_and_oracle_match_jax(scene):
    """The scene's targets and init cloud, and the oracle on one view
    (the sequential form against the scan form too)."""
    from gscream_tpu.data.synthetic import make_scene as jmake
    from gscream_tpu.ops import projection as jproj
    from gscream_tpu.ops.rasterize_ref import rasterize_scan as jscan
    from gscream_tpu_torch.data.synthetic import make_scene
    from gscream_tpu_torch.ops.projection import preprocess
    from gscream_tpu_torch.ops.rasterize_ref import (rasterize_scan,
                                                     rasterize_sequential)
    kw = dict(SCENE, width=64, height=48)
    js, ts = jmake(**kw), make_scene(device="cpu", **kw)
    np.testing.assert_array_equal(ts.points, js.points)
    for jv, tv in zip(js.views, ts.views):
        for f in ("image", "mask", "depth"):
            np.testing.assert_allclose(getattr(tv, f), getattr(jv, f),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
        np.testing.assert_allclose(tv.camera.full_proj.numpy(),
                                   np.asarray(jv.camera.full_proj),
                                   rtol=1e-6)
    assert ts.views[0].image.mean() > 0.1
    # the oracle itself, with the 16-pixel tiles of its default, on a
    # scene whose gaussians overlap enough to reach the T < 1e-4 stop
    rng = np.random.default_rng(71)
    n = 60
    pts = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    sc = rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    op = rng.uniform(0.5, 0.99, n).astype(np.float32)
    unc = rng.uniform(0, 1, n).astype(np.float32)
    jcam, cam = js.views[1].camera, ts.views[1].camera
    w, h = kw["width"], kw["height"]
    jsp = jproj.preprocess(pts, sc, q, jcam.w2c, jcam.full_proj, w, h,
                           jcam.tan_fovx, jcam.tan_fovy)
    tsp = preprocess(to_torch(pts), to_torch(sc), to_torch(q), cam.w2c,
                     cam.full_proj, w, h, cam.tan_fovx, cam.tan_fovy)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jo = jscan(jsp, col, op, unc, bg, w, h, block=1024)
    to = rasterize_scan(tsp, to_torch(col), to_torch(op), to_torch(unc),
                        to_torch(bg), w, h, block=1024)
    so = rasterize_sequential(tsp, to_torch(col), to_torch(op),
                              to_torch(unc), to_torch(bg), w, h)
    assert float(to.final_t.min()) < 1e-3
    for f in ("color", "depth", "uncertainty", "final_t"):
        np.testing.assert_allclose(getattr(to, f).numpy(),
                                   np.asarray(getattr(jo, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
        np.testing.assert_allclose(getattr(so, f).numpy(),
                                   getattr(to, f).numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f)


def _jax_token_draws(seed, steps, n):
    """JAX's token priorities for steps 1..steps of a run keyed with
    ``PRNGKey(seed + 1)`` (loop.py:210, step.py:222-226, 147-150)."""
    key = jax.random.PRNGKey(seed + 1)
    draws = {}
    for s in range(1, steps + 1):
        key, kc = jax.random.split(key)
        kf, kb = jax.random.split(jax.random.fold_in(kc, 0))
        draws[s] = (to_torch(jax.random.uniform(kf, (n,))),
                    to_torch(jax.random.uniform(kb, (n,))))
    return draws


def _jax_keep_draw(key, n, level, dev):
    for _ in range(level + 1):
        key, sub = jax.random.split(key)
    return to_torch(jax.random.uniform(sub, (n,)))


@pytest.fixture(scope="module")
def parity(scene, tmp_path_factory):
    """Both packages' loops from the JAX loop's initial model."""
    from gscream_tpu.config import ModelConfig as JModel
    from gscream_tpu.config import OptimConfig as JOptim
    from gscream_tpu.config import RunConfig as JRun
    from gscream_tpu.data.synthetic import make_scene as jmake
    from gscream_tpu.model.scaffold import ScaffoldConfig as JCfg
    from gscream_tpu.model.scaffold import init_scaffold as jinit
    from gscream_tpu.train.loop import train_scene as jtrain
    from gscream_tpu.train.state import init_train_state as jinit_ts
    from gscream_tpu_torch.model import densify
    from gscream_tpu_torch.model.io import save_checkpoint
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig
    from gscream_tpu_torch.train import loop, step
    from gscream_tpu_torch.train.state import train_state_from_numpy
    tmp = tmp_path_factory.mktemp("parity")
    run = _run(PARITY)
    jrun = JRun(model=JModel(**MODEL), optim=JOptim(**PARITY), seed=3)
    jscene = jmake(**SCENE)
    jlog_ts = {}

    def jcb(it, ts, aux):
        jlog_ts[it] = dict(
            loss=float(aux.packed[0]), cross_ok=bool(aux.packed[4]),
            alive=int(np.asarray(ts.scaffold.alive).sum()),
            stats=jax.tree.map(np.asarray, ts.stats) if it == 12 else None)
    jtrain(jscene.views, jscene.ref_index, jscene.points, jrun,
           out_dir=str(tmp / "jax"), capacity=CAP, iterations=24,
           callback=jcb, logger=_quiet_logger())

    # the JAX loop's initial state, as a port checkpoint at step 0
    kw = dict(feat_dim=8, n_offsets=2, voxel_size=0.1, capacity=512)
    jcfg, cfg = JCfg(**kw), ScaffoldConfig(**kw)
    j0 = jinit_ts(jinit(jax.random.PRNGKey(3), jscene.points, jcfg), jcfg,
                  jax.random.PRNGKey(4))
    ts0 = train_state_from_numpy(jax.tree.map(np.asarray, j0), cfg,
                                 device="cpu")
    ckpt = str(tmp / "start")
    save_checkpoint(ckpt, ts0)
    with open(ckpt + "_meta.json", "w") as f:
        f.write('{"iteration": 0, "capacity": %d}' % CAP)

    tokens = _jax_token_draws(3, 24, 512)
    saved = (step.token_priorities, loop.densify_generator,
             densify.keep_draw)
    step.token_priorities = lambda ts, n: tokens[ts.step + 1]
    loop.densify_generator = lambda seed, it, dev: jax.random.fold_in(
        jax.random.PRNGKey(seed + 2), it)
    densify.keep_draw = _jax_keep_draw
    try:
        port_ts = {}
        ts, log = loop.train_scene(
            scene.views, scene.ref_index, scene.points, run,
            out_dir=str(tmp / "port"), capacity=CAP, iterations=24,
            start_checkpoint=ckpt, device="cpu", logger=_quiet_logger(),
            callback=lambda it, t, aux: port_ts.__setitem__(
                it, int(t.scaffold.alive.sum())))
    finally:
        (step.token_priorities, loop.densify_generator,
         densify.keep_draw) = saved
    return jlog_ts, log, port_ts


@pytest.mark.timeout(240)
def test_loop_losses_track_jax(parity):
    jlog, log, _ = parity
    assert [s["it"] for s in log.steps] == list(range(1, 25))
    worst = {True: 0.0, False: 0.0}
    for s, loss in zip(log.steps, log.losses):
        it = s["it"]
        ref = jlog[it]["loss"]
        rtol = 1e-3 if it <= 12 else 1e-2
        assert abs(loss - ref) <= rtol * abs(ref), (it, loss, ref)
        assert s["cross_ok"] == jlog[it]["cross_ok"], it
        worst[it <= 12] = max(worst[it <= 12], abs(loss - ref) / abs(ref))
    print(f"worst relative loss error: {worst[True]:.2e} up to the "
          f"densification, {worst[False]:.2e} after it")
    phase2 = [s for s in log.steps if s["use_cross"]]
    assert len(phase2) == 8
    ok = [s for s in phase2 if s["cross_ok"]]
    assert len(ok) >= 2 and {s["is_ref"] for s in ok} == {True, False}, ok


@pytest.mark.timeout(240)
def test_densification_matches_jax(parity):
    """The anchor count after the densification at iteration 12."""
    from gscream_tpu.config import OptimConfig as JOptim
    jlog, log, port_alive = parity
    dens = [e for e in log.events if e["event"] == "densify"]
    assert [e["it"] for e in dens] == [12, 24]
    assert dens[0]["alive_after"] > dens[0]["alive_before"]
    got, want = port_alive[13], jlog[13]["alive"]
    print(f"anchors after the densification: {got}, JAX {want}")
    if got != want:
        st = jlog[12]["stats"]
        mean = st.offset_grad_accum / np.maximum(st.offset_denom, 1e-12)
        opt = JOptim(**PARITY)
        thr = [opt.densify_grad_threshold * 2 ** lv for lv in range(3)]
        near = np.argwhere(np.any([np.abs(mean - t) <= 1e-3 * t
                                   for t in thr], axis=0))
        assert abs(got - want) <= len(near), (
            f"{got} anchors against JAX's {want}; offsets within 1e-3 of "
            f"a threshold: {near.tolist()}")
    for it in range(13, 25):
        assert port_alive[it] == jlog[it]["alive"] or got != want, it


def _train(scene, optim, tmp, tag, iterations, **kw):
    from gscream_tpu_torch.train.loop import train_scene
    return train_scene(scene.views, scene.ref_index, scene.points,
                       _run(optim), out_dir=str(tmp / tag),
                       iterations=iterations, device="cpu",
                       logger=_quiet_logger(), **kw)


def _assert_states_equal(a, b):
    from gscream_tpu_torch.train.state import named_params
    assert a.step == b.step and a.step_c == b.step_c
    pa, pb = named_params(a.scaffold), named_params(b.scaffold)
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
        assert torch.equal(a.m[name], b.m[name]), name
        assert torch.equal(a.v[name], b.v[name]), name
    for f, x, y in zip(a.stats._fields, a.stats, b.stats):
        assert torch.equal(x, y), f
    assert torch.equal(a.scaffold.alive, b.scaffold.alive)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


RESUME = dict(iterations=16, start_crossattn_from=6, start_stat=0,
              update_from=0, update_interval=6, update_until=17)


@pytest.mark.timeout(240)
def test_kill_and_resume_bit_exact(scene, tmp_path):
    full, flog = _train(scene, RESUME, tmp_path, "full", 16, capacity=CAP)
    _train(scene, RESUME, tmp_path, "a", 8, capacity=CAP,
           checkpoint_interval=8)
    ckpt = str(tmp_path / "a" / "ckpt")
    assert os.path.exists(ckpt + "_meta.json")
    res, rlog = _train(scene, RESUME, tmp_path, "b", 16,
                       start_checkpoint=ckpt)
    assert [s["it"] for s in rlog.steps] == list(range(9, 17))
    _assert_states_equal(full, res)
    assert rlog.losses == flog.losses[8:]
    assert [e["it"] for e in flog.events if e["event"] == "densify"] == \
        [6, 12]
    assert any(s["cross_ok"] for s in flog.steps[8:])
    assert full.step_c > 0


@pytest.mark.timeout(240)
def test_overflow_rerun_bit_exact(scene, tmp_path):
    optim = dict(RESUME, iterations=8, start_crossattn_from=0)
    a, alog = _train(scene, optim, tmp_path, "small", 8, capacity=2048)
    first = [e for e in alog.events if e["event"] == "overflow"]
    assert first and first[0]["it"] == 1 and first[0]["capacity"] == 2048
    assert alog.steps[0]["use_cross"]
    b, blog = _train(scene, optim, tmp_path, "tier", 8,
                     capacity=first[0]["new_capacity"])
    _assert_states_equal(a, b)
    assert alog.losses == blog.losses
    assert all(s["instances"] <= s["capacity"] for s in alog.steps)


@pytest.mark.timeout(120)
def test_nonfinite_loss_dumps_the_pre_step_state(tmp_path):
    """A NaN target makes the first loss NaN: the step writes nothing, the
    loop saves that state and the step's inputs, and stops loudly."""
    from gscream_tpu_torch.data.synthetic import make_scene
    from gscream_tpu_torch.model.io import load_checkpoint
    from gscream_tpu_torch.train.loop import NonFiniteLossError
    sc = make_scene(device="cpu", **dict(SCENE, width=64, height=64))
    bad = [v._replace(image=np.full_like(v.image, np.nan)) for v in sc.views]
    with pytest.raises(NonFiniteLossError, match="iteration 1"):
        _train(sc._replace(views=bad), RESUME, tmp_path, "nan", 4,
               capacity=CAP)
    z = np.load(tmp_path / "nan" / "nonfinite_it1_inputs.npz")
    assert int(z["it"]) == 1 and int(z["num_instances"]) > 0
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig, \
        init_scaffold
    from gscream_tpu_torch.train.state import init_train_state
    cfg = ScaffoldConfig(feat_dim=8, n_offsets=2, voxel_size=0.1,
                         capacity=512)
    fresh = init_train_state(init_scaffold(
        sc.points, cfg, torch.Generator().manual_seed(3), device="cpu"),
        cfg, seed=4)
    dumped = load_checkpoint(str(tmp_path / "nan" / "nonfinite_it1_ckpt"),
                             init_train_state(init_scaffold(
                                 sc.points, cfg, torch.Generator(),
                                 device="cpu"), cfg))
    assert dumped.step == 0
    _assert_states_equal(dumped, fresh)


CA_FIRST = "to_qk"
PIPE = dict(RESUME, iterations=10, start_crossattn_from=5, update_interval=6)


@pytest.mark.timeout(240)
def test_pipeline_depth_3_equals_depth_1(scene, tmp_path, monkeypatch):
    from gscream_tpu_torch.train.state import named_params
    runs = {}
    for depth in ("1", "3"):
        monkeypatch.setenv("GSCREAM_PIPELINE", depth)
        seen = {}

        def cb(it, t, aux):
            p = named_params(t.scaffold)
            seen[it] = [x.clone() for x in (
                p["params/anchor"], p["params/offset"], p["mlps/color/0/w"],
                p["mlps/crossattn/" + CA_FIRST], t.m["params/offset"],
                t.v["mlps/color/0/w"], t.stats.offset_denom,
                t.stats.opacity_accum, t.step_c)] + [t.step]
        runs[depth] = _train(scene, PIPE, tmp_path, f"d{depth}", 10,
                             capacity=2048, checkpoint_interval=4,
                             callback=cb) + (seen,)
    (a, alog, aseen), (b, blog, bseen) = runs["1"], runs["3"]
    over = [e for e in alog.events if e["event"] == "overflow"]
    assert over and over[0]["it"] == 1
    assert [e["it"] for e in alog.events if e["event"] == "densify"] == [6]
    assert any(s["use_cross"] for s in alog.steps)
    assert alog.losses == blog.losses
    assert alog.steps == blog.steps and alog.events == blog.events
    _assert_states_equal(a, b)
    assert sorted(aseen) == sorted(bseen) == list(range(1, 11))
    for it in aseen:
        for x, y in zip(aseen[it], bseen[it]):
            assert (x == y) if isinstance(x, int) else torch.equal(x, y), it
    # the callbacks saw each step's own state, not a later one
    assert not torch.equal(aseen[2][1], aseen[3][1])



@pytest.mark.timeout(120)
@pytest.mark.parametrize("fault,phase2", [("overflow", False),
                                          ("nonfinite", False),
                                          ("overflow", True)])
def test_gated_step_writes_nothing(scene, fault, phase2):
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.model.scaffold import (ScaffoldConfig,
                                                  init_scaffold)
    from gscream_tpu_torch.train.state import (init_train_state,
                                               written_tensors)
    from gscream_tpu_torch.train.step import aux_values, train_step
    cfg = ScaffoldConfig(feat_dim=8, n_offsets=2, voxel_size=0.1,
                         capacity=512)
    opt = OptimConfig(**RESUME)
    ts = init_train_state(init_scaffold(
        scene.points, cfg, torch.Generator().manual_seed(3), device="cpu"),
        cfg, seed=4)
    v = scene.views[scene.ref_index]
    img, mask, depth = (torch.as_tensor(np.asarray(x, np.float32))
                        for x in (v.image, v.mask, v.depth))
    box = torch.tensor([0, SIZE, 0, SIZE], dtype=torch.int32)
    kw = dict(cfg=cfg, opt=opt, is_ref=True, use_crossattn=phase2,
              width=SIZE, height=SIZE, accumulate=True, feat_frozen=phase2)
    fg = torch.ones((SIZE, SIZE))
    ts, aux = train_step(ts, v.camera, img, mask, depth, fg, box,
                         capacity=CAP, **kw)        # moments and stats set
    first = aux_values(aux)
    assert np.isfinite(first[0])
    before = [t.clone() for t in written_tensors(ts)] + [
        t.clone() for t in ts.stats] + [ts.step_c.clone()]
    gen = ts.generator.get_state()
    if fault == "nonfinite":
        img = torch.full_like(img, float("nan"))
    cap = max(int(first[2]) // 2, 8) if fault == "overflow" else CAP
    new, aux = train_step(ts, v.camera, img, mask, depth, fg, box,
                          capacity=cap, **kw)
    vals = aux_values(aux)
    assert (vals[2] > cap) if fault == "overflow" else not np.isfinite(
        vals[0])
    after = written_tensors(new) + list(new.stats) + [new.step_c]
    for i, (x, y) in enumerate(zip(before, after)):
        assert torch.equal(x, y), i
    if phase2:
        assert bool(aux.cross_ok)
    else:
        assert torch.equal(new.generator.get_state(), gen)
