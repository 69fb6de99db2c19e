"""Shared set-up of the benchmark's own tests: the harness's folder and
the repository's root on the path, one torch thread, the card marker, and
the tiny cells the CPU tests drive (the shapes of the published widths,
at a few hundred anchors and a small frame)."""
import copy
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load(rel):
    with open(os.path.join(BENCH, rel)) as f:
        return json.load(f)


@pytest.fixture
def tiny():
    return tiny_cell


def tiny_cell(config, traffic, limits=None):
    """A cell of ``config`` under ``traffic`` at 384×256 (the phase-2 patch
    is 256 pixels, so the object is 1.2 wide) with 300 anchors at 0.3
    times the mean spacing (capacity 1024), a short warm-up and
    densification every 4 iterations."""
    cfg = copy.deepcopy(load(f"configs/{config}.json"))
    tr = copy.deepcopy(load(f"traffic/{traffic}.json"))
    s = cfg["scene"]
    s.update(width=384, height=256, n_anchors=300, start_capacity=8192,
             spiral_frames=4, object_radius=1.2)
    # the volume flattened to 0.3³ of its depth (a forward rig's z, an
    # orbit's height), so its mean spacing is 0.3 times the published
    # one's while the anchors still fill the frame around the object
    ax = 2 if s["rig"] == "forward" else 1
    mid = (s["volume_min"][ax] + s["volume_max"][ax]) / 2
    for key in ("volume_min", "volume_max"):
        s[key][ax] = mid + 0.3 ** 3 * (s[key][ax] - mid)
    if s["rig"] == "forward":
        s.update(n_views=10, n_test=4)
    else:
        s.update(n_views=12, test_every=4)
    cfg["model"]["anchor_capacity"] = 1024
    cfg["optim"]["crossattn_max_tokens"] = 64
    if tr["kind"] == "train":
        tr.update(warmup_iterations=5, settle_iterations=2, warmup_max=20,
                  trace_iterations=2)
        tr["schedule"]["update_interval"] = 4
    else:
        tr.update(sample_range=4, samples=2, trace_frames=2)
    return {"name": f"tiny.{config}.{traffic}", "chips": 1, "config": cfg,
            "traffic": tr, "limits": limits or {}}
