#!/usr/bin/env python3
"""Summarize a torch.profiler trace of the PyTorch/CUDA port: per-kernel
device time per iteration (counterpart of ``scripts/trace_summary.py``).

Usage: python3 trace_summary_torch.py <trace_dir|trace.json> [top_n]

Reads the Chrome trace that ``GSCREAM_TRACE=<dir>`` makes
``utils/trace.py::maybe_trace`` write (``<dir>/<label>/trace.json``; the
newest one under a directory), sums the durations of the card's events
(categories ``kernel``, ``gpu_memcpy``, ``gpu_memset``) by name over the
whole capture, and prints the device total, the iteration count
inferred as the median count of the 20 most expensive names, and the
top ``top_n`` names (default 40) with their ms per iteration and
counts.  The port's own CUDA kernels appear under their symbol names
(``tile_forward_kernel``, ...).  A trace with no device event (captured
without a card) exits non-zero.
"""
import sys

from gscream_tpu_torch.utils.trace import summary_main

if __name__ == "__main__":
    summary_main(sys.argv[1:])
