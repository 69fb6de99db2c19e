"""The PyTorch port's sharded training over a (data, tiles) mesh, on the
CPU: worlds of 2 or 4 spawned ranks over gloo, one thread each
(``parallel.distributed.spawn``; the rank functions live in
``parallel/workers.py``, so no child imports JAX or a test module), at the
sizes of ``tests/test_sharded.py``: ``ScaffoldConfig(feat_dim=8,
n_offsets=2, voxel_size=0.1, capacity=512)``, 64×64, the JAX package's
synthetic scene (4 views of 100 gaussians) carried across with
``train_state_from_numpy``.

Tolerances:
* mesh (1, 2) against (1, 1), one loss and its gradients: loss within
  1e-5 absolute, gradients rtol 1e-3 + atol 1e-5 (JAX's own bounds);
* mesh (2, 1): the loss is the mean of the two views' losses within 1e-5;
* the port at mesh (2, 2) against JAX's ``make_sharded_train_step`` at
  ``make_mesh(2, 2)``, two phase-1 steps with the statistics: the
  single-device step's budget of ``tests/test_torch_train_step.py``
  (loss rtol 1e-5; gradients and moments ``5e-3·scale + 2e-2·|JAX|``
  with at most 0.5% of a leaf's elements within ``5e-2·scale``; the step
  taken by a parameter where its gradient is above 1e-3 of the leaf's
  largest; the visibility counts equal);
* the loop at mesh (1, 2) against one device: losses rtol 5e-3,
  parameters rtol 5e-3 + atol 5e-4 (``test_train_scene_mesh_routing``'s);
* the replicas: bit-equal (SHA-256 of the whole state), after every run;
* the loop at mesh (1, 2) with ``GSCREAM_PIPELINE=3`` against ``1``,
  4 iterations with an overflow re-run of the first step and phase-2
  steps: the losses, steps and events equal and the final states
  bit-equal (the same digest).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import to_torch

W = H = 64
KW = dict(feat_dim=8, n_offsets=2, voxel_size=0.1, capacity=512)
CAP = 16384
FLIP_SHARE = 5e-3
SPAWN_S = 240
# TensorBoard's import (it loads TensorFlow) takes ~11 s; the loop's
# metrics go to JSONL without it
NO_TB = ("torch.utils.tensorboard",)


def _port_views(jviews):
    from gscream_tpu_torch.cameras import Camera
    from gscream_tpu_torch.data.synthetic import SyntheticView
    out = []
    for i, v in enumerate(jviews):
        c = v.camera
        cam = Camera(*(to_torch(getattr(c, f)) for f in (
            "w2c", "full_proj", "cam_center", "tan_fovx", "tan_fovy")),
            int(c.width), int(c.height))
        out.append(SyntheticView(cam, *(np.asarray(x, np.float32) for x in (
            v.image, v.mask, v.depth)), f"view_{i}"))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX scene and start state, the port's views, the state as a
    checkpoint the ranks load, and the phase-2 inputs."""
    from gscream_tpu.data.synthetic import make_scene
    from gscream_tpu.model.scaffold import ScaffoldConfig as JCfg
    from gscream_tpu.model.scaffold import init_scaffold
    from gscream_tpu.train.loop import (random_box_mask,
                                        sample_patch_in_mask_region)
    from gscream_tpu.train.state import init_train_state
    from gscream_tpu_torch.model.io import save_checkpoint
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig
    from gscream_tpu_torch.train.state import train_state_from_numpy
    jcfg, cfg = JCfg(**KW), ScaffoldConfig(**KW)
    scene = make_scene(n_views=4, n_gauss=100, width=W, height=H)
    sc = init_scaffold(jax.random.PRNGKey(0), scene.points, jcfg)
    # random features, so that the phase-2 EMA writes show (zero tokens
    # attend to zeros)
    feat = np.random.default_rng(9).normal(
        0, 0.3, sc.params.feat.shape).astype(np.float32)
    sc = sc._replace(params=sc.params._replace(feat=jnp.asarray(feat)))
    jts = init_train_state(sc, jcfg, jax.random.PRNGKey(1))
    ts = train_state_from_numpy(jax.tree.map(np.asarray, jts), cfg,
                                device="cpu")
    path = str(tmp_path_factory.mktemp("sharded") / "state.pt")
    save_checkpoint(path, ts)
    mask0 = np.asarray(scene.views[0].mask[0])
    rng = np.random.default_rng(np.random.SeedSequence([7, 1]))
    fg_box = random_box_mask(rng, mask0, 1.5, 0.8, H, W)
    cross_box = np.array(sample_patch_in_mask_region(rng, mask0, 48, 0.8, H,
                                                     W), np.int32)
    return dict(scene=scene, jts=jts, jcfg=jcfg, cfg=cfg, path=path,
                views=_port_views(scene.views), fg_box=fg_box,
                cross_box=cross_box)


def _batch(views, **kw):
    from gscream_tpu_torch.parallel.shard import sharded_view_batch
    return sharded_view_batch(views, device="cpu", **kw)


def _spawn(fn, n, *args):
    from gscream_tpu_torch.parallel.distributed import spawn
    return spawn(fn, n, *args, timeout_s=SPAWN_S, without=NO_TB)


@pytest.fixture(scope="module")
def losses(world):
    """``make_sharded_loss`` at (1, 1) in this process, and at (1, 2) and
    (2, 1) in worlds of two ranks."""
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.parallel.mesh import Mesh
    from gscream_tpu_torch.parallel.shard import make_sharded_loss
    from gscream_tpu_torch.parallel.workers import load_state, loss_worker
    cfg, opt, views = world["cfg"], OptimConfig(), world["views"]
    ts = load_state(world["path"], cfg, "cpu")
    one = make_sharded_loss(Mesh(), cfg, opt, CAP, W, H)
    single = [one(ts.scaffold, _batch([v])) for v in views[:2]]
    ranks = _spawn(loss_worker, 2, cfg, opt, CAP, W, H, world["path"],
                   [((1, 2), _batch(views[:1])), ((2, 1), _batch(views[:2]))])
    return dict(single=[(float(l_), g) for l_, g in single],
                tiles=[r[0] for r in ranks], data=[r[1] for r in ranks])


@pytest.mark.timeout(300)
def test_two_bands_equal_one(losses):
    """Mesh (1, 2) == (1, 1): the band-split loss and its gradients, the
    two ranks' bit-equal (the adjoints of the in-loss sums and the halo
    exchange hand each band its share; seeding the loss on every band
    would count it twice)."""
    l1, g1 = losses["single"][0]
    (l2, g2), (l2b, g2b) = losses["tiles"]
    assert l2 == l2b and all(torch.equal(g2[k], g2b[k]) for k in g2)
    assert abs(l1 - l2) < 1e-5
    assert set(g1) == set(g2) and len(g1) >= 10
    for k, ref in g1.items():
        np.testing.assert_allclose(g2[k].numpy(), ref.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    assert max(float(g.abs().max()) for g in g1.values()) > 1e-4


@pytest.mark.timeout(300)
def test_data_parallel_loss_is_the_mean(losses):
    """Mesh (2, 1): the loss is the mean of its two views' losses, and the
    gradient the mean of their gradients."""
    (l0, g0), (l1, g1) = losses["single"]
    (ld, gd), (ld_b, _) = losses["data"]
    assert ld == ld_b
    assert abs(ld - 0.5 * (l0 + l1)) < 1e-5
    for k in g0:
        ref = (0.5 * (g0[k] + g1[k])).numpy()
        np.testing.assert_allclose(gd[k].numpy(), ref, rtol=1e-3,
                                   atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def jax_parity(world):
    """Two phase-1 steps with the statistics at mesh (2, 2): JAX's
    ``make_sharded_train_step`` (one compile) and the port in a world of
    four ranks, which then takes a phase-2 step on a mixed batch."""
    from gscream_tpu.config import OptimConfig as JOpt
    from gscream_tpu.parallel.mesh import make_mesh as jmesh
    from gscream_tpu.parallel.shard import (make_sharded_train_step as jmake,
                                            sharded_view_batch as jbatch)
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.train.state import train_state_from_numpy
    from gscream_tpu_torch.parallel.workers import steps_worker
    scene, cfg = world["scene"], world["cfg"]
    step = jmake(jmesh(2, 2), world["jcfg"], JOpt(), CAP, W, H,
                 interpret=True)
    jts, jl = world["jts"], []
    for _ in range(2):
        jts, aux = step(jts, jbatch(scene.views[:2]), accumulate=True)
        jl.append(float(aux.loss))
    views = world["views"]
    phase1 = dict(batch=_batch(views[:2]), accumulate=True)
    phase2 = dict(batch=_batch(
        views[:2], fg_boxes=[world["fg_box"], np.zeros((H, W), np.float32)],
        is_ref=[True, False], cross_boxes=[world["cross_box"]] * 2,
        cross_enable=[True, False]), use_crossattn=True, feat_frozen=True)
    res = _spawn(steps_worker, 4, (2, 2), cfg, OptimConfig(), CAP, W, H,
                 world["path"], [phase1, phase1, phase2], 3)
    return dict(jax=train_state_from_numpy(jax.tree.map(np.asarray, jts),
                                           cfg, device="cpu"),
                jax_losses=jl, port=res)


def _close(got, ref, name, atol=5e-3, rtol=2e-2, flip_rel=5e-2,
           where=None):
    """``tests/test_torch_train_step.py``'s flip-aware bound."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    if where is not None:
        got, ref = got[where], ref[where]
    if ref.size == 0:
        return 0.0
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref)
    bad = err > atol * scale + rtol * np.abs(ref)
    assert bad.sum() <= max(2, FLIP_SHARE * ref.size), (
        f"{name}: {int(bad.sum())} of {ref.size} beyond the tight bound, "
        f"worst {err.max() / scale:.3e} of scale")
    assert err.max() <= flip_rel * scale, (
        f"{name}: worst {err.max() / scale:.3e} of scale")
    return float(err.max() / scale)


@pytest.mark.timeout(300)
def test_mesh_2x2_matches_jax(world, jax_parity):
    from gscream_tpu_torch.parallel.workers import load_state
    from gscream_tpu_torch.train.state import named_params
    port, ref = jax_parity["port"], jax_parity["jax"]
    assert len({r["digest"] for r in port}) == 1          # replicas
    np.testing.assert_allclose(port[0]["packed"][:2, 0].numpy(),
                               jax_parity["jax_losses"], rtol=1e-5)
    st = port[0]["states"][1]
    assert st["step"] == 2 == ref.step
    start = load_state(world["path"], world["cfg"], "cpu")
    p0 = named_params(start.scaffold)
    worst = {}
    for name, m in ref.m.items():
        got, want = st["m"][name].numpy(), m.numpy()
        if not want.any():
            np.testing.assert_array_equal(got, want, name)
            continue
        worst[name] = _close(got, want, f"m {name}")
        _close(st["v"][name].numpy(), ref.v[name].numpy(), f"v {name}")
        step_j = named_params(ref.scaffold)[name].detach().numpy() \
            - p0[name].detach().numpy()
        step_p = st["params"][name].numpy() - p0[name].detach().numpy()
        sel = np.abs(want) > 1e-3 * np.abs(want).max()
        _close(step_p, step_j, f"step of {name}", atol=1e-7 / max(
            np.abs(step_j[sel]).max(), 1e-30), where=sel)
    assert len(worst) >= 10, sorted(worst)
    for f in ("anchor_demon", "offset_denom"):
        np.testing.assert_array_equal(st["stats"][f].numpy(),
                                      getattr(ref.stats, f).numpy(), f)
    for f in ("opacity_accum", "offset_grad_accum"):
        _close(st["stats"][f].numpy(), getattr(ref.stats, f).numpy(), f)
    print(f"worst |Δm| / scale per leaf {worst}")


@pytest.mark.timeout(300)
def test_phase2_batch_gates_and_writes_feat_by_ema(world, jax_parity):
    """A mixed B = 2 batch in phase 2 (cross-attention on the reference
    view only): the step runs, the main Adam leaves ``feat`` alone, and
    the features change only at the sampled rows, through the EMA."""
    from gscream_tpu_torch.config import OptimConfig
    port = jax_parity["port"]
    before, after = port[0]["states"][1], port[0]["states"][2]
    loss, _, demand, _, cross_ok = port[0]["packed"][2].tolist()
    assert np.isfinite(loss) and demand <= CAP
    f0, f1 = before["params"]["params/feat"], after["params"]["params/feat"]
    changed = (f1 != f0).any(dim=1)
    assert torch.equal(after["m"]["params/feat"], before["m"]["params/feat"])
    assert int(changed.sum()) <= 2 * min(OptimConfig().crossattn_max_tokens,
                                         world["cfg"].capacity)
    ca = [k for k in after["params"] if k.startswith("mlps/crossattn/")]
    moved = any(not torch.equal(after["params"][k], before["params"][k])
                for k in ca)
    assert bool(cross_ok) == bool(changed.any()) == moved
    assert after["step_c"] == before["step_c"] + int(bool(cross_ok))
    assert bool(cross_ok)            # the patch holds >11 fg and bg anchors


@pytest.mark.timeout(300)
def test_loop_on_a_mesh_tracks_one_device(world, tmp_path, monkeypatch):
    """``train_scene(mesh=(1, 2))``, 10 iterations across the switch to
    phase 2, against the single-device loop; the loop checks the replicas
    itself, and the two ranks return the same digest."""
    from gscream_tpu_torch.config import ModelConfig, OptimConfig, RunConfig
    from gscream_tpu_torch.parallel.workers import (host_state,
                                                    train_scene_worker)
    from gscream_tpu_torch.train.loop import train_scene
    run = RunConfig(
        model=ModelConfig(feat_dim=8, n_offsets=2, voxel_size=0.1,
                          anchor_capacity=512),
        optim=OptimConfig(iterations=10, start_crossattn_from=6,
                          start_stat=1, update_from=10 ** 9,
                          update_until=10 ** 9))
    views, points = world["views"], np.asarray(world["scene"].points)
    kw = dict(capacity=CAP)
    for name in NO_TB:
        monkeypatch.setitem(sys.modules, name, None)
    ts, log = train_scene(views, 0, points, run,
                          out_dir=str(tmp_path / "single"), device="cpu",
                          **kw)
    res = _spawn(train_scene_worker, 2, (1, 2), views, 0, points, run,
                 str(tmp_path / "mesh"), kw)
    assert res[0]["digest"] == res[1]["digest"]
    assert any(s["use_cross"] for s in res[0]["steps"])
    np.testing.assert_allclose(res[0]["losses"], log.losses, rtol=5e-3)
    ref = host_state(ts)
    for k, t in ref["params"].items():
        np.testing.assert_allclose(res[0]["state"]["params"][k].numpy(),
                                   t.numpy(), rtol=5e-3, atol=5e-4,
                                   err_msg=k)


@pytest.mark.timeout(300)
def test_mesh_pipeline_depth_3_equals_depth_1(world, tmp_path):
    from gscream_tpu_torch.config import ModelConfig, OptimConfig, RunConfig
    from gscream_tpu_torch.parallel.workers import pipeline_worker
    run = RunConfig(
        model=ModelConfig(feat_dim=8, n_offsets=2, voxel_size=0.1,
                          anchor_capacity=512),
        optim=OptimConfig(iterations=4, start_crossattn_from=2,
                          start_stat=0, update_from=10 ** 9,
                          update_until=10 ** 9))
    res = _spawn(pipeline_worker, 2, (1, 2), world["views"], 0,
                 np.asarray(world["scene"].points), run, str(tmp_path),
                 dict(capacity=128), (1, 3))
    one, three = res[0]
    assert one["digest"] == three["digest"] == res[1][1]["digest"]
    assert one["losses"] == three["losses"]
    assert one["steps"] == three["steps"] and one["events"] == three["events"]
    over = [e for e in one["events"] if e["event"] == "overflow"]
    assert over and over[0]["it"] == 1, one["events"]
    assert any(s["use_cross"] for s in one["steps"])


@pytest.mark.timeout(120)
def test_nothing_falls_back_silently(tmp_path):
    """A CUDA rank without a card raises, NCCL on the CPU raises, a mesh
    the world does not fit raises; one process starts no process group;
    the automatic mesh puts tiles first."""
    from gscream_tpu_torch.parallel.distributed import (init_distributed,
                                                        rank_device)
    from gscream_tpu_torch.parallel.mesh import auto_shape, make_mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            rank_device("cuda", 0, 1, "gloo")
    with pytest.raises(ValueError, match="NCCL"):
        rank_device("cpu", 0, 1, "nccl")
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(1, 2)
    assert init_distributed("", 1, 0, device="cpu") is None
    assert auto_shape(8) == (1, 8) and auto_shape(12) == (3, 4)
    assert auto_shape(6) == (3, 2) and auto_shape(3) == (3, 1)


CLI = ["--synthetic", "--device", "cpu", "--synthetic_size", "32",
       "--iterations", "4", "--feat_dim", "8", "--n_offsets", "2",
       "--voxel_size", "0.1", "--anchor_capacity", "512",
       "--instance_capacity", "4096", "--start_crossattn_from", "3",
       "--skip_render", "--skip_eval"]


@pytest.mark.timeout(300)
def test_cli_trains_on_a_mesh(tmp_path, monkeypatch):
    """``train_torch.py --mesh_tiles 2 --dist_coordinator … --dist_nprocs 2
    --dist_pid I`` as two CPU processes (gloo) trains what one process
    trains (``train_log.json``'s losses, through phase 2), and the flags
    parse with their JAX meaning."""
    import socket
    import subprocess
    import json
    import train_torch
    args = train_torch.parse_args(CLI + ["--mesh_data", "2", "--mesh_tiles",
                                         "3", "--dist_nprocs", "6",
                                         "--dist_pid", "5"])
    assert (args.mesh_data, args.mesh_tiles, args.dist_nprocs,
            args.dist_pid, args.dist_coordinator) == (2, 3, 6, 5, "")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.modules['torch.utils.tensorboard'] = None; "
            "import train_torch; train_torch.main(sys.argv[1:])")
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code] + CLI
        + ["--model_path", str(tmp_path / "mesh"), "--mesh_tiles", "2",
           "--dist_coordinator", f"127.0.0.1:{port}", "--dist_nprocs", "2",
           "--dist_pid", str(r)], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=SPAWN_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    for name in NO_TB:
        monkeypatch.setitem(sys.modules, name, None)
    train_torch.main(CLI + ["--model_path", str(tmp_path / "single")])
    logs = [json.load(open(tmp_path / d / "train_log.json"))
            for d in ("mesh", "single")]
    assert len(logs[0]["losses"]) == 4
    assert [s["use_cross"] for s in logs[0]["steps"]] == [False] * 3 + [True]
    np.testing.assert_allclose(logs[0]["losses"], logs[1]["losses"],
                               rtol=5e-3)
