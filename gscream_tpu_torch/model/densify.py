"""Densification statistics (counterpart of the statistics part of
``gscream_tpu/model/densify.py``, :40-77; ``training_statis``,
gaussian_model.py:730-757).

Per anchor: opacity sums and visit counts over the views where it is
visible; per offset: the screen-space gradient norms (in the reference's
NDC units — the caller applies the ×0.5·W/H factors of backward.cu:592-593)
and their counts.  Growing and pruning (``adjust_anchors``) are not
ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .scaffold import ScaffoldConfig


class DensifyStats(NamedTuple):
    opacity_accum: torch.Tensor      # (C,1)
    anchor_demon: torch.Tensor       # (C,1) visit counts
    offset_grad_accum: torch.Tensor  # (C,k)
    offset_denom: torch.Tensor       # (C,k)
    grow_overflow: torch.Tensor      # () int32: candidates dropped for space


def init_stats(cfg: ScaffoldConfig, device) -> DensifyStats:
    C, k = cfg.capacity, cfg.n_offsets

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return DensifyStats(z(C, 1), z(C, 1), z(C, k), z(C, k),
                        torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def accumulate_stats(stats: DensifyStats, neural_opacity, screen_grad,
                     gauss_valid, anchor_visible) -> DensifyStats:
    """neural_opacity: (C,k) raw tanh outputs; screen_grad: (C,k) NDC-unit
    gradient norms of the 2D means; gauss_valid: (C,k) bool — the gaussian
    passed the opacity > 0 selection and was visible (radius > 0);
    anchor_visible: (C,) bool from the prefilter."""
    op = torch.clamp_min(neural_opacity, 0.0)
    vis = anchor_visible[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=op.device)
    opacity_accum = stats.opacity_accum + torch.where(
        vis, torch.sum(op, dim=1, keepdim=True), zero)
    anchor_demon = stats.anchor_demon + vis.to(torch.float32)
    upd = gauss_valid & vis
    offset_grad = stats.offset_grad_accum + torch.where(upd, screen_grad,
                                                        zero)
    offset_denom = stats.offset_denom + upd.to(torch.float32)
    return stats._replace(opacity_accum=opacity_accum,
                          anchor_demon=anchor_demon,
                          offset_grad_accum=offset_grad,
                          offset_denom=offset_denom)
