"""The benchmark's arithmetic: the window's rate and card time per
iteration, the 95th percentile over all frames, the idle share, the
device busy time and launch count of a capture, the roofline and the
blended-pair count on a hand-built tile."""
from types import SimpleNamespace

import pytest
import torch

import run as bench_run
from harness import spec, work
from harness.trace import Capture, Event, union_seconds
from reference import blend


def capture(events, ranges=(), gpu_ranges=(), ops=()):
    c = Capture()
    c.device = sorted((Event("kernel", n, s, e) for n, s, e in events),
                      key=lambda e: e.start)
    c.ranges = [Event("user_annotation", n, s, e) for n, s, e in ranges]
    c.gpu_ranges = [Event("gpu_user_annotation", n, s, e)
                    for n, s, e in gpu_ranges]
    c.ops = [Event("cpu_op", n, s, e) for n, s, e in ops]
    return c


def test_p95_over_all_frames():
    xs = [float(i) for i in range(1, 101)]      # 1..100
    assert bench_run._p95(xs) == 95.0
    assert bench_run._p95([3.0]) == 3.0
    assert bench_run._p95([1.0, 2.0]) == 2.0


def test_busy_is_the_union_and_gaps_are_named():
    c = capture([("a", 0.0, 1.0), ("b", 0.5, 1.5), ("c", 2.0, 2.5)],
                ranges=[("step/losses", 1.4, 2.2)])
    assert c.busy_seconds() == pytest.approx(2.0)
    assert c.count() == 3 and c.count("a") == 1
    assert c.idle_gaps() == [("step/losses", pytest.approx(0.5))]


def test_union_of_sorted_spans():
    assert union_seconds([]) == 0.0
    assert union_seconds([(0.0, 1.0), (0.2, 0.4), (0.9, 2.0),
                          (3.0, 3.5)]) == pytest.approx(2.5)


def test_window_card_ms_per_iteration():
    """The end-to-end line of an untraced training run: the card's busy
    time over the whole window per committed iteration, and set-up."""
    cell = {"end_to_end": [{"name": "train_gpu_ms_per_it", "unit": "ms"},
                           {"name": "setup_s", "unit": "s"}]}
    res = SimpleNamespace(kind="train", busy_s=3.0, units=200,
                          setup_s=12.5, rate=25.0)
    assert bench_run.metrics_line(cell, res, False) == {
        "train_gpu_ms_per_it": {"value": pytest.approx(15.0), "unit": "ms"},
        "setup_s": {"value": 12.5, "unit": "s"}}
    # a run with no window profile (the CPU) reports no card time
    res.busy_s = None
    assert "train_gpu_ms_per_it" not in bench_run.metrics_line(cell, res,
                                                               False)


def test_seconds_under_a_range():
    c = capture([("k1", 0.0, 1.0), ("k2", 1.0, 3.0), ("k3", 4.0, 5.0)],
                gpu_ranges=[("step/crossattn", 0.5, 2.0)])
    assert c.seconds_under("step/crossattn") == pytest.approx(1.5)


def ctx(**res):
    r = SimpleNamespace(**res)
    return SimpleNamespace(res=r, model={"feat_dim": 32, "n_offsets": 10},
                           optim={"attn_head_num": 8, "attn_head_dim": 64})


def test_window_rate_and_idle_share():
    c = capture([("k", 0.0, 0.25), ("k", 0.5, 0.75)])
    x = ctx(capture=c, trace_units=2, window_s=10.0, units=20, kind="train",
            rate=2.0)
    assert spec.metric_reader("loop.it_per_s")(x) == 2.0
    # 0.25 s busy per iteration against 0.5 s of wall per iteration
    assert spec.metric_reader("device.idle_share.train")(x) == \
        pytest.approx(50.0)
    assert spec.metric_reader("launches_per_it.train")(x) == 1.0
    assert spec.metric_reader("loop.dispatch_ms")(ctx(dispatch_s=[
        0.01, 0.03])) == pytest.approx(20.0)
    assert spec.metric_reader("loop.reruns_per_kit")(ctx(
        overflows=2, units=500)) == pytest.approx(4.0)


def test_readers_find_nothing_without_a_trace():
    x = ctx(capture=None, trace_units=0, window_s=1.0, units=1, work=None,
            phase2_units=0)
    for name in ("device.idle_share.train", "launches_per_it.train",
                 "k2_roofline", "train_mfu", "crossattn.device_ms",
                 "k1_roofline.render", "render_mfu"):
        assert spec.metric_reader(name)(x) is None


def test_roofline_share_and_mfu():
    w = {"pairs": 10 ** 9, "instances": 10 ** 6, "pixels": 10 ** 6,
         "tiles": 1000, "anchors": 0, "tokens": 0}
    ops, moved = work.k2_work(w)
    least = work.least_seconds(ops, moved)
    assert least == pytest.approx(ops / work.F32_PEAK)
    c = capture([("tile_backward_kernel<false>", 0.0, 2 * least),
                 ("tile_backward_kernel<false>", 1.0, 1.0 + 2 * least)])
    x = ctx(capture=c, work=[w], trace_units=2, window_s=1.0, units=1)
    assert spec.metric_reader("k2_roofline")(x) == pytest.approx(50.0)
    mfu = spec.metric_reader("train_mfu")(x)
    assert mfu == pytest.approx(100.0 * (work.K1_OPS_PER_PAIR
                                         + work.K2_OPS_PER_PAIR) * 1e9
                                / work.F32_PEAK)


def test_blended_pairs_on_a_hand_built_tile():
    """One 32×32 tile, three gaussians at its centre pixel (10, 10) with
    conic 0 (α = opacity at every pixel): opacities 0.5, 0.002 (below
    1/255: skipped) and 0.99, then 0.99 again.  T goes 1 → 0.5 → 0.005 →
    5e-5 < 1e-4: the fourth stops the blend and is not blended.  Every
    pixel of the tile blends the same three pairs... of which two count
    (the 0.002 one is skipped)."""
    n = 4
    mean2d = torch.full((n, 2), 10.0)
    conic = torch.zeros((n, 3))
    cov = torch.full((n, 3), 1.0)
    op = torch.tensor([0.5, 0.002, 0.99, 0.99])
    depth = torch.tensor([1.0, 2.0, 3.0, 4.0])
    radius = torch.full((n,), 5.0)
    bins = blend.bin_tiles(mean2d, cov, op, depth, radius, 32, 32)
    g = (mean2d, conic, op, torch.rand(n, 3), depth, torch.rand(n))
    w = blend.blended_work(g, bins)
    # the 0.002 gaussian is never listed (its α ≥ 1/255 box is empty)
    assert w["pairs"] == 2 * 32 * 32 and w["instances"] == 2
    assert w["pixels"] == 1024 and w["tiles"] == 1
    c, d, u, t = blend.render(g, bins, 32, 32, torch.zeros(3))
    assert torch.allclose(t, torch.full((32, 32), 0.005))
    assert torch.allclose(d, torch.full((32, 32), 0.5 * 1 + 0.5 * 0.99 * 3))
