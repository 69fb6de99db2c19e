"""``trace_summary_torch.py`` and ``profile_train_step_torch.py`` on the
CPU (no JAX is needed: ``scripts/trace_summary.py`` imports none).

* The summary of a hand-made torch.profiler Chrome trace equals
  ``scripts/trace_summary.py``'s, run unchanged (imported by path) on a
  TPU-style trace holding the same durations: the totals and counts by
  name, the inferred iteration count and every printed row.  Each
  layout carries the events its script must leave out (the host's, and
  the grouping rows: torch's ``gpu_user_annotation``, XLA's "XLA
  Modules").
* A trace without a device event exits non-zero with the JAX script's
  message, and a directory without a trace with its own.
* ``profile_train_step_torch.py --device cpu`` on a small trained model
  (300 anchors, 64×48, 2 iterations) prints the three ``train_step``
  lines with the JAX script's labels and the four loss-head lines, and
  under ``GSCREAM_TRACE`` writes one trace per variant, a CPU capture
  that the summary refuses.
* A variant whose steps overflow the counted tier is run again from
  the model's state at the training loop's overflow tier.
* Without a card and without ``--device cpu`` it raises.
"""
import contextlib
import gzip
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import tests.test_torch_common  # noqa: F401  (one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ITERS = 5


def jax_script(name):
    """A script of ``scripts/`` imported by path, unchanged."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_records(seed=0):
    """(name, µs) of the card's work over ``ITERS`` iterations in launch
    order: K2 and K1, the longest, and eighteen more kernels once per
    iteration, four several times (short ones, as elementwise kernels
    are), a copy and a fill."""
    rng = np.random.default_rng(seed)
    long, mid, short = (900.0, 1000.0), (10.0, 900.0), (0.5, 6.0)
    per_iter = (
        [("void (anonymous namespace)::tile_backward_kernel<false>(...)", 1,
          long),
         ("void (anonymous namespace)::tile_forward_kernel<false>(...)", 1,
          long)]
        + [(f"void gs::kernel_{i}<false>(float const*, int)", 1, mid)
           for i in range(18)]
        + [(f"void at::native::vectorized_elementwise_kernel<{i}>(...)", 3,
            short) for i in range(4)]
        + [("Memcpy DtoH (Device -> Pinned)", 1, short),
           ("Memset (Device)", 2, short)])
    out = []
    for _ in range(ITERS):
        for name, reps, (lo, hi) in per_iter:
            for _ in range(reps):
                out.append((name, round(float(rng.uniform(lo, hi)), 3)))
    return out


def torch_trace(records, with_device=True):
    """The records as ``torch.profiler``'s ``export_chrome_trace`` lays
    them out, with the host's ops, runtime calls and ranges beside
    them."""
    cats = {"Memcpy": "gpu_memcpy", "Memset": "gpu_memset"}
    ev = [{"ph": "M", "name": "process_name", "pid": 4242,
           "args": {"name": "python3"}},
          {"ph": "X", "cat": "user_annotation", "name": "bench_64x48",
           "pid": 4242, "tid": 4242, "ts": 0.0, "dur": 9e4}]
    ts = 10.0
    for name, us in records:
        ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mul",
                   "pid": 4242, "tid": 4242, "ts": ts, "dur": 3.0})
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "pid": 4242, "tid": 4242,
                   "ts": ts + 1, "dur": 2.0})
        if with_device:
            ev.append({"ph": "X", "cat": cats.get(name.split()[0], "kernel"),
                       "name": name, "pid": 0, "tid": 7, "ts": ts + 5,
                       "dur": us, "args": {"device": 0, "stream": 7}})
        ts += us + 10
    if with_device:
        ev.append({"ph": "X", "cat": "gpu_user_annotation",
                   "name": "step/adam", "pid": 0, "tid": 7, "ts": 5.0,
                   "dur": ts})
    return {"schemaVersion": 1, "traceEvents": ev}


def tpu_trace(records):
    """The same device records as the JAX profiler's trace lays them
    out: a TPU core's process beside the host's."""
    ev = [{"ph": "M", "name": "process_name", "pid": 1,
           "args": {"name": "/device:TPU:0"}},
          {"ph": "M", "name": "process_name", "pid": 2,
           "args": {"name": "/host:CPU"}},
          {"ph": "X", "name": "XLA Modules", "pid": 1, "tid": 1, "ts": 0,
           "dur": 1e5}]
    ts = 10.0
    for name, us in records:
        ev.append({"ph": "X", "name": "PjitFunction", "pid": 2, "tid": 1,
                   "ts": ts, "dur": 3.0})
        ev.append({"ph": "X", "name": name, "pid": 1, "tid": 2,
                   "ts": ts + 5, "dur": us})
        ts += us + 10
    return {"traceEvents": ev}


def write(path, data):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "wt") as f:
        json.dump(data, f)


def printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def test_summary_matches_jax_script(tmp_path, monkeypatch):
    from gscream_tpu_torch.utils import trace
    jts = jax_script("trace_summary")
    records = device_records()
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    old = str(tdir / "older" / "trace.json")
    write(old, torch_trace(records[:7]))
    os.utime(old, (1, 1))
    write(str(tdir / "bench_64x48" / "trace.json"), torch_trace(records))
    write(str(jdir / "plugins" / "profile" / "run" / "vm.trace.json.gz"),
          tpu_trace(records))

    path = trace.find_trace_json(str(tdir))
    assert path == str(tdir / "bench_64x48" / "trace.json")
    tot, cnt = trace.device_totals(trace.load_events(path))
    # the JAX script's own selection, on its layout
    events = jts.load_events(jts.find_trace_json(str(jdir)))
    dev = jts.device_pids(events)
    jtot, jcnt = {}, {}
    for e in events:
        name = e.get("name", "")
        if (e.get("ph") != "X" or e.get("pid") not in dev
                or name.startswith(("XLA Modules", "Steps", "XLA Ops "))):
            continue
        jtot[name] = jtot.get(name, 0.0) + e.get("dur", 0.0)
        jcnt[name] = jcnt.get(name, 0) + 1
    assert tot == jtot and cnt == jcnt and len(tot) == 26
    assert trace.inferred_iterations(tot, cnt) == ITERS

    top_n = 8
    monkeypatch.setattr(sys, "argv", ["trace_summary.py", str(jdir),
                                      str(top_n)])
    want = printed(jts.main)
    got = printed(trace.summary_main, [str(tdir), str(top_n)])
    assert got[0] == f"# {path}" and want[0].startswith("# ")
    assert got[1:] == want[1:]
    assert f"inferred iters={ITERS} ->" in got[1]
    assert got[-1].endswith(f"(+{26 - top_n} more)")
    assert len(got) == 4 + top_n + 1
    for k in ("tile_forward_kernel", "tile_backward_kernel"):
        assert any(k in row for row in got[4:-1]), k


def test_summary_exits_without_device_events(tmp_path):
    write(str(tmp_path / "cpu" / "label" / "trace.json"),
          torch_trace(device_records(1), with_device=False))
    (tmp_path / "empty").mkdir()
    for where, message in (("cpu", "no device events found"),
                           ("empty", "no trace.json(.gz) under")):
        r = subprocess.run([sys.executable, "trace_summary_torch.py",
                            str(tmp_path / where)], cwd=ROOT,
                           capture_output=True, text=True, timeout=60)
        assert r.returncode != 0 and message in r.stderr, (where, r)
        assert r.stdout == ""


def small_model(d, w=64, h=48, n_anchors=300):
    """A trained-model directory of the port's layout: ``cfg.json``,
    ``point_cloud/iteration_7/`` and one camera in ``cameras.json``."""
    from gscream_tpu_torch.config import ModelConfig, RunConfig, save_config
    from gscream_tpu_torch.model.io import save_anchors_ply, save_mlps_npz
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig, init_scaffold
    cfg = ScaffoldConfig(feat_dim=32, n_offsets=10, voxel_size=0.01,
                         capacity=512)
    pts = np.random.default_rng(0).normal(0, 0.6, (n_anchors, 3))
    st = init_scaffold(pts.astype(np.float32), cfg,
                       torch.Generator().manual_seed(0), device="cpu")
    ply = os.path.join(d, "point_cloud", "iteration_7")
    os.makedirs(ply)
    save_config(RunConfig(model=ModelConfig(
        feat_dim=32, n_offsets=10, voxel_size=0.01, anchor_capacity=512)),
        os.path.join(d, "cfg.json"))
    save_anchors_ply(os.path.join(ply, "point_cloud.ply"), st, cfg)
    save_mlps_npz(os.path.join(ply, "mlp_checkpoints.npz"), st.mlps)
    f = 0.5 * w / np.tan(0.5)
    with open(os.path.join(d, "cameras.json"), "w") as fh:
        json.dump([{"rotation": np.eye(3).tolist(),
                    "position": [0.0, 0.0, -3.0], "width": w, "height": h,
                    "fx": f, "fy": f}], fh)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("profile") / "model")
    small_model(d)
    return d


@pytest.mark.timeout(120)
def test_profile_script_on_cpu(model_dir, tmp_path, monkeypatch):
    import profile_train_step_torch as prof
    from gscream_tpu_torch.utils import trace
    model, traces = model_dir, str(tmp_path / "traces")
    monkeypatch.setenv("GSCREAM_TRACE", traces)
    lines = printed(prof.main, [model, "2", "--device", "cpu"])
    with open(os.path.join(ROOT, "scripts", "profile_train_step.py")) as f:
        labels = re.findall(r'run\("([^"]+)"', f.read())
    assert labels == [label for label, _ in prof.VARIANTS] and len(labels) == 3
    assert re.fullmatch(r"model iter 7  64x48  anchors 512  instances \d+  "
                        r"tier 16384", lines[0]), lines[0]
    for line, label in zip(lines[1:4], labels):
        m = re.fullmatch(rf"{label} +([\d.]+) ms  \(([\d.]+) it/s\)", line)
        assert m and float(m[1]) > 0, line
    heads = [f"loss_terms is_ref={r} {nm:10s}" for r in (False, True)
             for nm in ("fwd", "fwd+bwd")]
    assert len(lines) == 8
    for line, head in zip(lines[4:], heads):
        m = re.fullmatch(re.escape(head) + r" +([\d.]+) ms", line)
        assert m and float(m[1]) > 0, line
    for label in labels:
        path = os.path.join(traces, label, "trace.json")
        assert os.path.getsize(path) > 0
        with pytest.raises(SystemExit, match="no device events found"):
            trace.summary_main([path])


@pytest.mark.timeout(60)
def test_overflowing_variant_reruns_at_the_loops_tier(model_dir, capsys):
    """A variant whose warm-up overflows the counted tier (its steps
    write nothing) is run again from the model's state at
    ``train/loop.py``'s overflow tier: the state after it is bit-equal
    to the same steps run at that tier alone."""
    import profile_train_step_torch as prof
    from gscream_tpu_torch.train.loop import overflow_tier
    from gscream_tpu_torch.train.state import (StatePool, init_train_state,
                                               written_tensors)
    from gscream_tpu_torch.train.step import aux_values
    cfg, sc, cam, w, h, opt, _ = prof.load_model(model_dir, "cpu")
    step = prof.step_fn(cfg, opt, cam, prof.step_inputs(
        np.random.default_rng(0), w, h, "cpu"), w, h)
    ts = init_train_state(sc, cfg, 0)
    pool = StatePool()
    start = pool.snapshot(ts)
    label, kw = prof.VARIANTS[0]
    _, aux = step(ts, 1024, **kw)          # overflows: writes nothing
    demand = int(aux_values(aux)[2])
    assert demand > 1024
    ts, cap, dt = prof.time_variant(step, pool, start, ts, 1024, label, kw,
                                    2, lambda: None)
    assert cap == overflow_tier(demand, 1024) >= demand and dt > 0
    assert (f"# {label}: demand [{demand}, ") in capsys.readouterr().err
    got = [t.clone() for t in written_tensors(ts)]
    ts = pool.restore(start, ts)
    for _ in range(3):
        ts, _ = step(ts, cap, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, written_tensors(ts)))
    assert not all(torch.equal(a, b) for a, b in zip(
        got, written_tensors(start)))


def test_profile_wants_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    import profile_train_step_torch as prof
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prof.main([str(tmp_path), "2"])
