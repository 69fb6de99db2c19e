"""``bench_torch.py`` against ``bench.py`` on the CPU.

JAX's bench scene (``bench.py::_bench_scene``: feat_dim 32, 10 offsets,
voxel 0.01, anchor capacity 2^15) at 64×48 with 500 anchors, carried
across to the port with ``scaffold_from_numpy``:

* ``_count_instances``: the (instances, rows) counts equal;
* ``_build_workload`` at the capacity tier the bench derives from them
  (JAX's Pallas kernels in interpret mode, the port's plain twins): the
  loss within rtol 1e-5, the instance count and overflow demand equal,
  every gradient leaf within ``tests/test_torch_train_step.py``'s budget
  (``_close``: 5e-3·scale + 2e-2·|JAX|, at most 0.5% of a leaf beyond it
  but within 5e-2·scale);
* ``utils/trace.py::maybe_trace`` writes a Chrome trace under
  ``GSCREAM_TRACE`` and nothing without it;
* ``bench_torch.py`` without a CUDA device prints ``bench.py``'s error
  record and exits non-zero.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_common import to_torch  # noqa: F401
from tests.test_torch_train_step import _close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

W, H, N_ANCHORS = 64, 48, 500


@pytest.fixture(scope="module")
def scenes():
    import bench
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.model.scaffold import (ScaffoldConfig,
                                                  scaffold_from_numpy)
    jcfg, jsc, jcam = bench._bench_scene(W, H, N_ANCHORS, 10, 0)
    cfg = ScaffoldConfig(feat_dim=32, n_offsets=10, voxel_size=0.01,
                         capacity=1 << 15)
    params, mlps = jax.tree.map(np.asarray, (jsc.params, jsc.mlps))
    sc = scaffold_from_numpy(params, mlps, np.asarray(jsc.alive), cfg,
                             np.asarray(jsc.xyz_max), device="cpu")
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 1.0,
                      1.0 * H / W, W, H, device="cpu")
    return dict(jax=(jcfg, jsc, jcam), port=(cfg, sc, cam))


@pytest.mark.timeout(120)
def test_count_instances_matches_bench(scenes):
    import bench
    import bench_torch
    want = tuple(int(x) for x in bench._count_instances(*scenes["jax"],
                                                          W, H))
    got = bench_torch._count_instances(*scenes["port"], W, H)
    assert got == want and got[0] > 0 and got[1] > 0, (got, want)


@pytest.mark.timeout(180)
def test_workload_matches_bench(scenes):
    import bench
    import bench_torch
    from gscream_tpu_torch.model.scaffold import scaffold_from_numpy
    from gscream_tpu_torch.train.state import named_params
    cfg, sc, _ = scenes["port"]
    cap = bench_torch._capacity(*bench_torch._count_instances(
        *scenes["port"], W, H))
    grad_fn, args = bench._build_workload(*scenes["jax"], W, H, cap)
    (jloss, (jn, jd)), (ga, gm) = grad_fn(*args)
    loss, grads, (n, d) = bench_torch._build_workload(
        *scenes["port"], W, H, cap)()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert int(n) == int(jn) and int(d) == int(jd) <= cap
    ga, gm = jax.tree.map(np.asarray, (ga, gm))
    want = named_params(scaffold_from_numpy(
        ga, gm, np.asarray(sc.alive), cfg, np.asarray(sc.xyz_max),
        device="cpu"))
    assert set(grads) == {k for k in want
                          if not k.startswith("mlps/crossattn/")}
    worst = {name: _close(g.numpy(), want[name].detach().numpy(), name)
             for name, g in grads.items()}
    assert any(float(g.abs().max()) > 0 for g in grads.values())
    print(f"loss {float(loss):.7f} (JAX {float(jloss):.7f}); worst "
          f"|port − JAX| / scale per leaf {worst}")


def test_maybe_trace_writes_only_when_asked(tmp_path, monkeypatch):
    from gscream_tpu_torch.utils.trace import maybe_trace
    monkeypatch.delenv("GSCREAM_TRACE", raising=False)
    with maybe_trace("off"):
        (torch.ones(8) * 2).sum()
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv("GSCREAM_TRACE", str(tmp_path))
    with maybe_trace("bench_64x48"):
        (torch.ones(8) * 2).sum()
    path = tmp_path / "bench_64x48" / "trace.json"
    with open(path) as f:
        assert json.load(f)["traceEvents"]


@pytest.mark.timeout(120)
def test_bench_without_cuda_exits_nonzero():
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["status"] == "error" and rec["value"] is None
    assert rec["metric"] == "rays_per_s_fwd_bwd_1297x840"
