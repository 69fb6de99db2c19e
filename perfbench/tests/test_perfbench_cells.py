"""Each cell run end to end at a tiny size on the CPU (the port's plain
kernels): a sound run comes out correct under the cell's limits, and a
run with a fault planted under the timed path comes out not correct —
for training a step that leaves the state unchanged and a loss over half
the view's pixels, and in phase 1 a step that gathers no statistics and
a densification that changes nothing; for the render a frame altered
where it is made.  The control (the reference with TF32 in the
program's place) is held on the card, where TF32 exists.  The garden
configuration's cells wait under the benchmark's open questions: its
tiny cells are held to the limits of spinnerf's cell of the same mix and
to ``limits/garden.render.json``."""
import sys
import tempfile
import time

import pytest
import torch

from conftest import load
from harness import compare, faults, render_cell, spec, train_cell
from harness.trace import Capture

# the port's plain kernels on the CPU add in other orders than its CUDA
# kernels, so a sound CPU run is held to these; the faults to the cell's
# own limits
CPU_LIMITS = {"l1_1_gap": 2e-5, "l1_gap": 1e-4}

TRAIN = [("spinnerf", "train_p1", "spinnerf.train_p1"),
         ("spinnerf", "train_p2", "spinnerf.train_p2"),
         ("garden", "train_p1", "spinnerf.train_p1")]
FAULTS = {"train_p1": [None, "unchanged", "half_batch", "no_stats",
                       "no_densify"],
          "train_p2": [None, "unchanged", "half_batch"]}
RENDER_LIMITS = "limits/garden.render.json"


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorboard", None)


def drive(cell, seed, fault=None, trace=False):
    drv = train_cell if cell["traffic"]["kind"] == "train" else render_cell
    import contextlib
    with tempfile.TemporaryDirectory() as tmp, (
            faults.planted(fault) if fault else contextlib.nullcontext()):
        res = drv.run(cell, seed, 0.5, trace, torch.device("cpu"), tmp,
                      time.perf_counter(), capture_cls=Capture)
    return res, compare.judge(res.numbers, cell["limits"])[0]


@pytest.mark.parametrize("config,traffic,name,fault", [
    (c, t, n, f) for c, t, n in TRAIN for f in FAULTS[t]])
def test_train_cell(tiny, config, traffic, name, fault):
    limits = dict(spec.cell(name)["limits"])
    if fault is None:
        limits.update(CPU_LIMITS)
    cell = tiny(config, traffic, limits)
    res, correct = drive(cell, 2 ** 31 + 11, fault)
    assert res.units >= 1 and res.rate > 0
    assert correct is (fault is None), res.numbers


class FakeBusy:
    """:class:`harness.trace.DeviceBusy`'s calls, without a profiler: one
    second of card time per iteration."""

    def __init__(self):
        self.prof, self.seconds, self.sessions = None, 0.0, []

    def start(self):
        assert self.prof is None
        self.prof = True

    def stop(self, units=0):
        assert self.prof
        self.prof = None
        self.seconds += units
        self.sessions.append((units, units, float(units), 0.0))

    def reset(self):
        self.seconds, self.sessions = 0.0, []


def test_window_sessions_cover_the_window(tiny, monkeypatch):
    """An untraced run's profiler sessions cover the window's iterations,
    each once, none of set-up's; none is left running."""
    monkeypatch.setattr(train_cell, "SESSION_ITERATIONS", 3)
    cell = tiny("spinnerf", "train_p1",
                dict(spec.cell("spinnerf.train_p1")["limits"], **CPU_LIMITS))
    with tempfile.TemporaryDirectory() as tmp:
        res = train_cell.run(cell, 2 ** 31 + 13, 1.0, False,
                             torch.device("cpu"), tmp, time.perf_counter(),
                             busy_cls=FakeBusy)
    assert res.units >= 1
    assert res.busy_s == res.units
    assert sum(s[0] for s in res.busy_sessions) == res.units
    assert all(s[0] <= 3 for s in res.busy_sessions)


@pytest.mark.parametrize("fault", [None, "altered"])
def test_render_cell(tiny, fault):
    cell = tiny("garden", "render_loop", load(RENDER_LIMITS))
    res, correct = drive(cell, 2 ** 31 + 12, fault, trace=fault is None)
    assert res.units >= 1 and res.failed == 0
    assert correct is (fault is None), res.numbers


@pytest.mark.requires_cuda
@pytest.mark.parametrize("config,traffic,limits", [
    ("spinnerf", "train_p1", "limits/spinnerf.train_p1.json"),
    ("spinnerf", "train_p2", "limits/spinnerf.train_p2.json"),
    ("garden", "render_loop", RENDER_LIMITS)])
def test_control_fails_on_the_card(tiny, config, traffic, limits):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 exists on a CUDA card only")
    import readings
    small = tiny(config, traffic, load(limits))
    with tempfile.TemporaryDirectory() as tmp:
        nums = readings.control_numbers(small, 5, torch.device("cuda"), tmp)
    assert not compare.judge(nums, small["limits"])[0], nums
