"""The numbers that decide ``correct``, each held to its limit from the
cell's ``limits/<cell>.json``.

Training (the first three iterations of the run's own loop against the
reference's):

* ``loss1_gap``: the relative gap of the first iteration's loss (the
  later iterations carry Adam's first step, which moves every element by
  its learning rate in the direction of its gradient's sign, so that an
  element whose gradient is round-off moves either way: the first loss
  is the one that a lower precision moves and round-off does not);
* ``loss_gap``: the largest relative gap of an iteration's loss;
* ``l1_1_gap`` and ``l1_gap``: the same for the L1 colour term of the
  loss (the loss's scale-and-shift depth alignment solves normal
  equations whose float32 determinant cancels, which moves the loss by
  up to ~2e-5 of itself under any change of summation order; the L1
  term is free of it);
* ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first gradient as Adam took it (its first
  moment after one step, over 1 − β1), against the larger of that leaf's
  reference norm and the median leaf's;
* ``change_gap``: the same for each leaf's change over the three
  iterations, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf below that moves under Adam by
  round-off alone);
* ``color1_p99`` and ``depth1_p99``: the first iteration's rendered image
  and depth against the reference's, as the render's numbers below (a
  lower precision of the decoders moves every pixel, where the loss
  averages the moves away);
* ``stats_gap`` (where the schedule gathers densification statistics):
  over the four accumulators after three iterations (the decoders'
  opacity sums, the visit counts, the screen-gradient sums and their
  counts), the largest norm of the program's minus the reference's over
  the reference's norm;
* ``densify_gap`` (where the schedule densifies): the first
  densification, the reference's run on the program's state and
  statistics just before it (the reference cannot reach iteration 100 on
  its own in the time a run has): the slots pruned on one side alone,
  the difference of the counts grown, and the grown anchors whose
  position or features differ, over the anchors alive before it.  The
  decisions are exact on both sides, so this is 0 unless one side errs.

Render (sampled frames of the window against the reference's render of
the same cameras from the same state): ``color_p99``, ``depth_p99`` and
``unc_p99``, the 99th percentiles of the absolute differences over every
pixel (and channel) of the sampled frames, depth relative to the larger
of 1 and the reference's depth (the 99th percentile leaves out the few
pixels whose T < 1e-4 stop moves by one gaussian under another rounding).
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

MIN_LEAF_SHARE = 1e-3


def _gap(p: Dict[str, float], r: Dict[str, float], names: List[str]):
    if not names:
        return 0.0
    med = statistics.median(r[n] for n in names)
    return max(abs(p[n] - r[n]) / max(r[n], med, 1e-30) for n in names)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def train_numbers(prog, ref) -> Dict[str, float]:
    loss_gap = max(_rel(a, b) for a, b in zip(prog["loss"], ref["loss"]))
    moved = [n for n in ref["g1"] if ref["g1"][n] > 0.0]
    grad_gap = _gap(prog["g1"], ref["g1"], moved)
    med = statistics.median(ref["g1"][n] for n in moved) if moved else 0.0
    kept = [n for n in moved if ref["g1"][n] >= MIN_LEAF_SHARE * med]
    img = (image_gaps([prog["image1"]], [ref["image1"]])
           if prog["image1"] is not None else {"color_p99": None,
                                               "depth_p99": None})
    out = {"loss1_gap": _rel(prog["loss"][0], ref["loss"][0]),
           "loss_gap": loss_gap,
           "l1_1_gap": _rel(prog["l1"][0], ref["l1"][0]),
           "l1_gap": max(_rel(a, b) for a, b in zip(prog["l1"], ref["l1"])),
           "grad_gap": grad_gap,
           "change_gap": _gap(prog["d3"], ref["d3"], kept),
           "color1_p99": img["color_p99"], "depth1_p99": img["depth_p99"],
           "leaves_compared": float(len(kept))}
    if ref.get("stats3") is not None:
        out["stats_gap"] = max(
            float(torch.linalg.vector_norm((prog["stats3"][n] - r).double())
                  / max(float(torch.linalg.vector_norm(r.double())), 1e-30))
            for n, r in ref["stats3"].items())
    return out


def densify_gap(before_alive, after_alive, after_anchor, after_feat,
                new_xyz, new_feat, pruned) -> float:
    """The program's first densification (its ``alive`` before, and
    ``alive``, positions and features after) against the reference's
    outcome on the same input (new positions and features in slot order,
    the pruned slots)."""
    grown = after_alive & ~before_alive
    miss = int(((before_alive & ~after_alive) ^ pruned).sum())
    n_new = int(grown.sum())
    miss += abs(n_new - len(new_xyz))
    if n_new == len(new_xyz):
        miss += int(((after_anchor[grown] != new_xyz).any(1)
                     | (after_feat[grown] != new_feat).any(1)).sum())
    return miss / max(1, int(before_alive.sum()))


def _p99(x: torch.Tensor) -> float:
    x = x.flatten().float()
    k = max(1, int(0.99 * x.numel()))
    return float(torch.kthvalue(x.cpu(), k).values)


def image_gaps(frames, refs) -> Dict[str, float]:
    """``frames`` and ``refs``: lists of (colour (H,W,3), depth, ...)."""
    dc = torch.cat([(a[0] - b[0]).abs().flatten()
                    for a, b in zip(frames, refs)])
    dd = torch.cat([((a[1] - b[1]).abs() / torch.clamp_min(b[1].abs(), 1.0))
                    .flatten() for a, b in zip(frames, refs)])
    return {"color_p99": _p99(dc), "depth_p99": _p99(dd)}


def render_numbers(frames, refs) -> Dict[str, float]:
    """``frames`` and ``refs``: lists of (colour (H,W,3), depth, unc)."""
    du = torch.cat([(a[2] - b[2]).abs().flatten()
                    for a, b in zip(frames, refs)])
    return dict(image_gaps(frames, refs), unc_p99=_p99(du))


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, lines): each compared number beside its limit."""
    ok, lines = True, []
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        lines.append(f"{name} {v!r} limit {limit!r}"
                     f"{'' if good else ' FAILED'}")
    return ok, lines
