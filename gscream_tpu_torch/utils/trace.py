"""Profiler trace capture behind ``GSCREAM_TRACE=<dir>`` (counterpart of
``gscream_tpu/utils/trace.py``), and its per-kernel summary (the
functions of ``scripts/trace_summary.py``; ``trace_summary_torch.py``).

The bench wraps its timed region in :func:`maybe_trace`.  With the
variable unset it does nothing; with it set, ``torch.profiler`` records
the block (host activity, and the card's kernels and copies where there
is a card) and writes a Chrome trace to ``<dir>/<label>/trace.json``,
which Perfetto or ``chrome://tracing`` opens.

Usage::

    with maybe_trace("bench_fwd_bwd"):
        for _ in range(iters):
            out = grad_fn()
        torch.cuda.synchronize()

    GSCREAM_TRACE=traces python bench_torch.py
    python trace_summary_torch.py traces/bench_1297x840
"""
from __future__ import annotations

import contextlib
import os
import sys


@contextlib.contextmanager
def maybe_trace(label: str):
    """Record the enclosed block into ``$GSCREAM_TRACE/<label>/trace.json``
    (a no-op when the variable is unset); says where on stderr, so that a
    caller's standard output keeps its own lines."""
    base = os.environ.get("GSCREAM_TRACE")
    if not base:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = os.path.join(base, label)
    os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(out, "trace.json")
    prof.export_chrome_trace(path)
    print(f"# trace written: {path} (Perfetto / chrome://tracing)",
          file=sys.stderr)


# ---------------------------------------------------------------------------
# Summary of a trace (counterpart of ``scripts/trace_summary.py``)

# Chrome-trace categories of the card's own activity in a torch.profiler
# trace: kernels (PyTorch's and the ones launched through ctypes alike,
# as CUPTI records every launch) and copies and fills.  Everything else
# (``cpu_op``, ``cuda_runtime``, ``user_annotation`` and the ranges'
# ``gpu_user_annotation`` twins, which span kernels already counted) is
# the host's or a grouping.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace_json(path: str) -> str:
    """``path`` itself if it is a file, else the newest ``*trace.json``
    or ``*trace.json.gz`` under it (``maybe_trace`` writes
    ``<label>/trace.json``)."""
    if os.path.isfile(path):
        return path
    hits = [os.path.join(root, f) for root, _, files in os.walk(path)
            for f in files if f.endswith(("trace.json", "trace.json.gz"))]
    if not hits:
        raise SystemExit(f"no trace.json(.gz) under {path}")
    return max(hits, key=os.path.getmtime)


def load_events(path: str) -> list:
    import gzip
    import json
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def device_totals(events):
    """({name: total µs}, {name: count}) over the complete (``ph`` "X")
    events of the card's categories."""
    tot, cnt = {}, {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        name = e.get("name", "")
        tot[name] = tot.get(name, 0.0) + e.get("dur", 0.0)
        cnt[name] = cnt.get(name, 0) + 1
    return tot, cnt


def inferred_iterations(tot, cnt) -> int:
    """The median count of the 20 most expensive names: the capture's
    repetition count where each of them runs once per iteration."""
    top = sorted(tot.items(), key=lambda kv: -kv[1])
    counts = [cnt[k] for k, _ in top[:20]]
    return max(1, sorted(counts)[len(counts) // 2])


def summary_lines(path: str, tot, cnt, top_n: int = 40) -> list:
    """The summary as ``scripts/trace_summary.py`` prints it: a header
    with the device total and the ms per inferred iteration, then
    ``ms/iter  count  name`` rows, largest first, and a ``(+N more)``
    row for the rest."""
    top = sorted(tot.items(), key=lambda kv: -kv[1])
    iters = inferred_iterations(tot, cnt)
    total_us = sum(tot.values())
    lines = [f"# {path}",
             f"# device total {total_us / 1e3:.1f} ms over capture, "
             f"inferred iters={iters} -> {total_us / iters / 1e3:.2f} "
             f"ms/iter\n",
             f"{'ms/iter':>8}  {'count':>5}  op"]
    lines += [f"{us / iters / 1e3:8.3f}  {cnt[name]:5d}  {name[:110]}"
              for name, us in top[:top_n]]
    rest = sum(us for _, us in top[top_n:])
    lines.append(f"{rest / iters / 1e3:8.3f}  {'':5}  "
                 f"(+{max(0, len(top) - top_n)} more)")
    return lines


def summary_main(argv) -> None:
    """``trace_summary_torch.py <trace_dir|trace.json> [top_n]``: prints
    the summary; exits non-zero when the trace holds no device event (a
    capture without a card)."""
    path = find_trace_json(argv[0] if argv else ".")
    top_n = int(argv[1]) if len(argv) > 1 else 40
    tot, cnt = device_totals(load_events(path))
    if not tot:
        raise SystemExit("no device events found")
    print("\n".join(summary_lines(path, tot, cnt, top_n)))
