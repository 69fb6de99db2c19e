#!/usr/bin/env python3
"""Run one cell of gscream_tpu_torch's benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for.  The run builds the cell's scene from the seed, warms up, runs
the cell's traffic for ``--seconds``, checks what the timed path produced
against the plain reference in ``perfbench/reference/``, and prints one
JSON line last on standard output: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
traced stretch of the same traffic after the window.  The numbers that
decide ``correct`` are printed beside their limits as the last lines of
standard error and under ``checks`` in the result.

The cell (``BENCHMARK.json``) names a configuration
(``perfbench/configs/``) and a traffic mix (``perfbench/traffic/<mix>
.json``, whose ``kind`` picks the runner: ``train`` or ``render``); the
limits of its comparison are ``perfbench/limits/<cell>.json`` and each
per-layer metric is read by ``perfbench/metrics/<metric>.py``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "gscream_tpu")


def set_environment():
    """Every cache of the run at a fixed path inside the checkout; the
    program's switches at their defaults."""
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, ".cache", "perfbench", "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(ROOT, ".cache", "perfbench",
                                       "torch_extensions"))
    # one process with few threads: the loop's host work is one thread,
    # and idle thread pools spinning beside it only add noise
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(k, "1")
    for k in [k for k in os.environ if k.startswith("GSCREAM_")]:
        del os.environ[k]
    sys.path[:0] = [HERE, ROOT]


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (``gscream_tpu_torch`` is another name)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def smi():
    try:
        import subprocess
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def host_state():
    """The host's load and CPU clock policy, and this process's CPU time:
    the training cells are bound by one host thread."""
    try:
        with open("/sys/devices/system/cpu/cpu0/cpufreq/"
                  "scaling_governor") as f:
            gov = f.read().strip()
    except OSError:
        gov = None
    return {"load1": os.getloadavg()[0], "cpus": len(os.sched_getaffinity(0)),
            "governor": gov,
            "wall": time.perf_counter(), "cpu": time.process_time()}


def host_line(h0, h1):
    """The host over the run: load and clock policy at both ends, and
    this process's CPU seconds over its wall seconds."""
    return {"load1": [h0["load1"], h1["load1"]], "cpus": h1["cpus"],
            "governor": h1["governor"],
            "process_cpu_share": (h1["cpu"] - h0["cpu"])
            / max(h1["wall"] - h0["wall"], 1e-9)}


def metrics_line(cell, res, trace: bool):
    from harness import spec
    out = {}
    if not trace:
        for m in cell["end_to_end"]:
            v = {"setup_s": res.setup_s,
                 "train_gpu_ms_per_it": (1e3 * res.busy_s / res.units
                                         if res.kind == "train"
                                         and res.busy_s else None),
                 "render_fps": res.rate if res.kind == "render" else None,
                 "render_ms_p95": (_p95(res.latencies) * 1e3
                                   if res.kind == "render" else None),
                 }.get(m["name"])
            if v is not None:
                out[m["name"]] = {"value": v, "unit": m["unit"]}
        return out
    from types import SimpleNamespace
    ctx = SimpleNamespace(res=res, cell=cell, model=cell["config"]["model"],
                          optim=cell["config"]["optim"])
    for m in cell["per_layer"]:
        v = spec.metric_reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _p95(xs):
    """The 95th percentile of all values (nearest rank)."""
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, -(-95 * len(s) // 100) - 1))]


def run_cell(name, seed, seconds, trace, device, tmp):
    """One run of cell ``name``; returns (result object, cell spec)."""
    import torch

    from harness import render_cell, spec, train_cell
    from harness.trace import Capture, DeviceBusy
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    cell = spec.cell(name)
    runner = {"train": train_cell, "render": render_cell}[
        cell["traffic"]["kind"]]
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kw = ({"busy_cls": DeviceBusy}
          if runner is train_cell and dev.type == "cuda" else {})
    res = runner.run(cell, seed, seconds, trace, dev, tmp, T_START,
                     capture_cls=Capture, **kw)
    return res, cell


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    set_environment()
    host0 = host_state()
    import torch
    from harness import compare, spec
    cell = spec.cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    tmp = tempfile.mkdtemp(prefix="perfbench-", dir=base)
    try:
        res, cell = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                             "cuda", tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    correct, lines = compare.judge(res.numbers, cell["limits"])
    line = {"correct": correct, "attempted": res.attempted,
            "failed": res.failed,
            "metrics": metrics_line(cell, res, bool(a.trace)),
            "device": {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0), "count": 1,
                       "memory_peak_bytes": int(res.peak or 0)}}
    if a.trace:
        line["device"]["busy_s"] = res.capture.busy_seconds()
        line["device"]["window_s"] = res.trace_t[1] - res.trace_t[0]
        line["breakdown"] = {
            "device_ops": sorted(res.capture.totals().items(),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": res.capture.idle_gaps(10)}
    line["power"] = smi()
    line["host"] = host_line(host0, host_state())
    line["checks"] = {n: {"value": res.numbers.get(n), "limit": lim}
                      for n, lim in cell["limits"].items()}
    print(f"# {a.workload} seed {a.seed}: {res.units} {res.kind} units in "
          f"{res.window_s:.3f} s; set-up {res.setup_s:.3f} s; numbers "
          f"{json.dumps(res.numbers)}", file=sys.stderr)
    for units, events, busy, stop in getattr(res, "busy_sessions", []):
        print(f"# window profiler session: {units} units, {events} device "
              f"events, {busy:.6f} s busy, stopped in {stop:.3f} s",
              file=sys.stderr)
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
