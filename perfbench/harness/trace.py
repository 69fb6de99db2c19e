"""The profiler's side of a run, its events kept in memory (nothing is
written to disk).  :class:`Capture` is a traced run's: ``torch.profiler``
started and stopped around a stretch of the run's own traffic and reduced
to what the per-layer readers take: the card's events (kernels, copies
and fills), the host's ranges (``record_function``) and the idle gaps
between device events.  :class:`DeviceBusy` is the measured window's: the
card's busy time over all of it, the card's activity alone.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, NamedTuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Event(NamedTuple):
    kind: str
    name: str
    start: float     # seconds on the profiler's clock
    end: float


class Capture:
    """Start with :meth:`start`, stop with :meth:`stop`; then ``device``,
    ``ranges`` (the host's ``record_function`` ranges), ``gpu_ranges``
    (their device-side spans) and ``ops`` (the host's operators)."""

    def __init__(self):
        self.prof = None
        self.device: List[Event] = []
        self.ranges: List[Event] = []
        self.gpu_ranges: List[Event] = []
        self.ops: List[Event] = []

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self):
        self.prof.stop()
        for e in self.prof.profiler.kineto_results.events():
            kind = _kind(e)
            ev = Event(kind, e.name(), e.start_ns() * 1e-9,
                       (e.start_ns() + e.duration_ns()) * 1e-9)
            if kind in DEVICE_KINDS:
                self.device.append(ev)
            elif kind == "gpu_user_annotation":
                self.gpu_ranges.append(ev)
            elif kind == "user_annotation":
                self.ranges.append(ev)
            elif kind == "cpu_op":
                self.ops.append(ev)
        self.prof = None
        self.device.sort(key=lambda e: e.start)

    def busy_seconds(self) -> float:
        """The union of the device events' intervals."""
        return union_seconds((e.start, e.end) for e in self.device)

    def totals(self, match=None) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.device:
            if match is None or match in e.name:
                out[e.name] = out.get(e.name, 0.0) + e.end - e.start
        return out

    def count(self, match=None) -> int:
        return sum(1 for e in self.device
                   if match is None or match in e.name)

    def seconds_under(self, range_name: str) -> float:
        """Device time of the events inside the device-side spans of the
        range ``range_name``."""
        spans = sorted((r.start, r.end) for r in self.gpu_ranges
                       if r.name == range_name)
        tot, j = 0.0, 0
        for e in self.device:
            while j < len(spans) and spans[j][1] < e.start:
                j += 1
            k = j
            while k < len(spans) and spans[k][0] <= e.end:
                lo, hi = max(spans[k][0], e.start), min(spans[k][1], e.end)
                if hi > lo:
                    tot += hi - lo
                k += 1
        return tot

    def idle_gaps(self, top=10):
        """The idle time between device events, summed by what the host
        was inside at each gap's middle (the innermost range, else the
        operator, else ``host``): the ``top`` largest."""
        gaps = []
        end = None
        for e in self.device:
            if end is not None and e.start > end:
                gaps.append((end, e.start))
            end = e.end if end is None else max(end, e.end)
        by: Dict[str, float] = {}
        ranges = _Cover(self.ranges)
        ops = _Cover(self.ops)
        for lo, hi in gaps:
            mid = 0.5 * (lo + hi)
            name = ranges.at(mid) or ops.at(mid) or "host"
            by[name] = by.get(name, 0.0) + hi - lo
        return sorted(by.items(), key=lambda kv: -kv[1])[:top]


class DeviceBusy:
    """The card's busy time over a long stretch: ``torch.profiler`` with the
    card's activity alone, started with :meth:`start` and stopped with
    :meth:`stop`, each session reduced at once to the union of its device
    events' intervals and dropped.  The profiler holds a session's records
    in buffers of bounded size until it stops, so a caller splits a long
    stretch into sessions of a few tens of iterations.  Both ends wait
    for the card, so that a session holds all the work launched inside
    it."""

    def __init__(self):
        self.prof = None
        self.seconds = 0.0
        # (units, device events, busy seconds, seconds the stop took)
        self.sessions: List[tuple] = []

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self, units: int = 0):
        import time

        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.prof.stop()
        spans = [(e.start_ns() * 1e-9,
                  (e.start_ns() + e.duration_ns()) * 1e-9)
                 for e in self.prof.profiler.kineto_results.events()
                 if _kind(e) in DEVICE_KINDS]
        self.prof = None
        busy = union_seconds(sorted(spans))
        self.seconds += busy
        self.sessions.append((units, len(spans), busy,
                              time.perf_counter() - t0))

    def reset(self):
        self.seconds, self.sessions = 0.0, []


def union_seconds(spans) -> float:
    """The length of the union of ``(start, end)`` intervals sorted by
    start."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _kind(e) -> str:
    """The event's Kineto activity kind, from ``activity_type()`` where
    this PyTorch has it, else from its device, its annotation flag and
    its name (CUPTI names copies ``Memcpy ...`` and fills ``Memset ...``;
    the CUDA runtime's calls start with ``cuda``)."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type()).split(".")[-1].lower()
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    name = e.name()
    if "cuda" in str(e.device_type()).lower():
        if annotation:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if annotation:
        return "user_annotation"
    return "cuda_runtime" if name.startswith("cuda") else "cpu_op"


class _Cover:
    """The innermost (latest-starting) event covering a time, among
    events sorted by start; looks back at most ``reach`` events."""

    def __init__(self, events, reach=4096):
        self.events = sorted(events, key=lambda e: e.start)
        self.starts = [e.start for e in self.events]
        self.reach = reach

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - self.reach, -1), -1):
            if self.events[j].end >= t:
                return self.events[j].name
        return None
