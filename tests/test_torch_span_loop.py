"""The anchor span in the training loop (``train/loop.py::train_scene``),
on the CPU, without JAX.

A synthetic scene of 1,000 anchors in 4,096 slots (span 1,024), with a
densification at iterations 4 and 8 whose gradient threshold of 0 grows
anchors past the span, phase 2 from iteration 7 and a start at an
instance capacity of 1,024 that overflows at iterations 2 and 7, on
either side of the growth:

* every ``TrainLog.steps`` record carries ``span``, which never
  decreases, is the state's own span, and grows after a densification
  that wrote past it (its ``span_after``);
* an overflowed step's re-run runs at the span it was launched with;
* a run resumed from the checkpoint at iteration 5, whose template state
  has the span of the scene's start, recomputes the span from the
  checkpoint, and ends bit-equal to the uninterrupted run with the same
  spans step for step.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_common import two_torch_threads  # noqa: F401

SIZE = 64
SCENE = dict(n_views=3, n_gauss=200, width=SIZE, height=SIZE, seed=4)
N_ANCHORS = 1000
MODEL = dict(feat_dim=8, n_offsets=2, voxel_size=0.001,
             anchor_capacity=4096)
OPTIM = dict(start_stat=0, update_from=0, update_interval=4,
             update_until=9, densify_grad_threshold=0.0,
             start_crossattn_from=6, crossattn_max_tokens=64)
ITERS = 10


def _quiet_logger():
    import logging
    lg = logging.getLogger("test_torch_span_loop")
    lg.propagate = False
    lg.handlers[:] = [logging.NullHandler()]
    return lg


def _train(scene, tmp, tag, iterations, **kw):
    from gscream_tpu_torch.config import ModelConfig, OptimConfig, RunConfig
    from gscream_tpu_torch.train.loop import train_scene
    run = RunConfig(model=ModelConfig(**MODEL),
                    optim=OptimConfig(**OPTIM), seed=5)
    points = np.random.default_rng(6).normal(0.0, 0.5, (N_ANCHORS, 3))
    return train_scene(scene.views, scene.ref_index, points, run,
                       out_dir=str(tmp / tag), capacity=1024,
                       iterations=iterations, device="cpu",
                       logger=_quiet_logger(), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted run with its per-step spans, and the run resumed
    from its checkpoint at iteration 5."""
    from gscream_tpu_torch.data.synthetic import make_scene
    tmp = tmp_path_factory.mktemp("span_loop")
    scene = make_scene(device="cpu", **SCENE)
    spans = {}
    whole, log = _train(scene, tmp, "whole", ITERS, checkpoint_interval=5,
                        callback=lambda it, ts, aux: spans.__setitem__(
                            it, ts.span))
    first, _ = _train(scene, tmp, "first", 5, checkpoint_interval=5)
    resumed, rlog = _train(scene, tmp, "resumed", ITERS,
                           start_checkpoint=str(tmp / "first" / "ckpt"))
    return dict(whole=whole, log=log, spans=spans, first=first,
                resumed=resumed, rlog=rlog)


@pytest.mark.timeout(300)
def test_span_logged_and_never_decreasing(runs):
    log = runs["log"]
    spans = [s["span"] for s in log.steps]
    assert [s["it"] for s in log.steps] == list(range(1, ITERS + 1))
    assert spans[0] == 1024
    assert all(a <= b for a, b in zip(spans, spans[1:])), spans
    # the state after step k, before any densification, is the state
    # step k ran on in span
    assert [runs["spans"][it] for it in range(1, ITERS + 1)] == spans
    assert runs["whole"].span == spans[-1]


@pytest.mark.timeout(300)
def test_span_grows_past_a_densification(runs):
    from gscream_tpu_torch.train.state import anchor_span
    log = runs["log"]
    dens = [e for e in log.events if e["event"] == "densify"]
    assert [e["it"] for e in dens] == [4, 8]
    grew = dens[0]
    assert grew["alive_after"] > 1024 and grew["span_after"] > 1024
    assert log.steps[grew["it"]]["span"] == grew["span_after"]
    assert log.steps[grew["it"] - 1]["span"] == 1024
    assert dens[1]["span_after"] >= grew["span_after"]
    assert anchor_span(runs["whole"]) <= runs["whole"].span
    alive = runs["whole"].scaffold.alive
    assert not bool(alive[runs["whole"].span:].any())


@pytest.mark.timeout(300)
def test_overflow_rerun_reuses_the_span(runs):
    log = runs["log"]
    over = [e for e in log.events if e["event"] == "overflow"]
    assert [e["it"] for e in over] == [2, 7]
    for e in over:
        rec = log.steps[e["it"] - 1]
        assert rec["capacity"] == e["new_capacity"] > e["capacity"]
        # no densification between the step and the one before it
        assert rec["span"] == log.steps[e["it"] - 2]["span"]
    assert [log.steps[e["it"] - 1]["span"] for e in over] == [1024, 2048]


@pytest.mark.timeout(300)
def test_resumed_run_recomputes_the_span(runs):
    from gscream_tpu_torch.train.state import named_params
    first, resumed, whole = runs["first"], runs["resumed"], runs["whole"]
    assert first.span > 1024      # the template's span is the start's
    rsteps = runs["rlog"].steps
    assert [s["it"] for s in rsteps] == list(range(6, ITERS + 1))
    assert [s["span"] for s in rsteps] == [
        s["span"] for s in runs["log"].steps[5:]]
    assert rsteps[0]["span"] == first.span
    pa, pb = named_params(resumed.scaffold), named_params(whole.scaffold)
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name
        assert torch.equal(resumed.m[name], whole.m[name]), name
        assert torch.equal(resumed.v[name], whole.v[name]), name
    assert np.array_equal(resumed.scaffold.alive.numpy(),
                          whole.scaffold.alive.numpy())
