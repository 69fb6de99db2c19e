"""Profiler trace capture behind ``GSCREAM_TRACE=<dir>`` (counterpart of
``gscream_tpu/utils/trace.py``).

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
