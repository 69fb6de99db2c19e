"""Scaffold-GS's densification (``anchor_growing`` and ``adjust_anchor`` of
``scene/gaussian_model.py``): from the statistics that ``training_statis``
gathered since the last densification, new anchors grow at the voxels of
offsets whose mean screen gradient passed a threshold, level by level,
and anchors seen often but rarely opaque are pruned.

Departures from the published code:

* the anchors are padded to a fixed capacity with an ``alive`` mask, so a
  new anchor that finds no free slot is dropped (in voxel order);
* a voxel coordinate is ``round`` of the product with the float32
  reciprocal of the voxel size, not of the quotient (the two differ only
  at a .5 tie);
* the random keep of each level draws its uniforms from a device
  ``torch.Generator`` seeded from ``(seed + 2, iteration)`` (the
  published code draws from the global stream);
* new anchors are returned in the order they would be appended: level by
  level, each level's voxels sorted lexicographically.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def keep_draws(seed: int, it: int, n: int, levels: int, device):
    """The ``levels`` uniform vectors of length ``n`` that the
    densification at iteration ``it`` keeps its candidates by."""
    s = np.random.SeedSequence([seed + 2, it]).generate_state(1, np.uint64)
    g = torch.Generator(device=device).manual_seed(int(s[0]) >> 1)
    return [torch.rand(n, generator=g, device=device) for _ in range(levels)]


def _coords(xyz, size):
    inv = float(np.float32(1.0) / np.float32(size))
    return torch.round(xyz * inv).to(torch.int32)


@torch.no_grad()
def adjust_anchors(p: Dict[str, torch.Tensor], alive, stats, draws: List,
                   model: Dict, optim: Dict):
    """``p``: ``anchor`` (C,3), ``offset`` (C,k,3), ``scaling`` (C,6),
    ``feat`` (C,F); ``stats``: ``opacity_accum``, ``anchor_demon`` (C,1),
    ``offset_grad_accum``, ``offset_denom`` (C,k).  Returns the new
    anchors' positions (N,3) and features (N,F), and the pruned slots."""
    C, k = p["offset"].shape[:2]
    F = p["feat"].shape[1]
    interval = optim["update_interval"]
    thr0 = optim["densify_grad_threshold"]
    hier = model["update_hierachy_factor"]

    grads = stats["offset_grad_accum"] / stats["offset_denom"]
    grads = torch.nan_to_num(grads, nan=0.0).reshape(-1)
    offset_mask = (stats["offset_denom"]
                   > interval * optim["success_threshold"] * 0.5).reshape(-1)
    offset_mask &= alive.repeat_interleave(k)
    cand_xyz = (p["anchor"][:, None, :]
                + p["offset"] * torch.exp(p["scaling"][:, None, :3])
                ).reshape(-1, 3)
    feat_rep = p["feat"].repeat_interleave(k, 0)

    existing = p["anchor"][alive]
    n_free = C - int(alive.sum())
    new_xyz, new_feat = [], []
    for level in range(model["update_depth"]):
        thr = thr0 * (hier // 2) ** level
        size = model["voxel_size"] * (model["update_init_factor"]
                                      // hier ** level)
        cand = (grads >= thr) & offset_mask & (draws[level]
                                               > 0.5 ** (level + 1))
        vox, group = torch.unique(_coords(cand_xyz[cand], size), dim=0,
                                  return_inverse=True)
        fmax = torch.full((len(vox), F), -torch.inf,
                          device=feat_rep.device).scatter_reduce(
            0, group[:, None].expand(-1, F), feat_rep[cand], "amax")
        ex = _coords(existing, size)
        both, inv = torch.unique(torch.cat([ex, vox]), dim=0,
                                 return_inverse=True)
        taken = torch.zeros(len(both), dtype=torch.bool, device=inv.device)
        taken[inv[:len(ex)]] = True
        fresh = ~taken[inv[len(ex):]]
        xyz = (vox[fresh].to(torch.float32) * size)[:n_free]
        new_xyz.append(xyz)
        new_feat.append(fmax[fresh][:n_free])
        n_free -= len(xyz)
        existing = torch.cat([existing, xyz])

    demon = stats["anchor_demon"][:, 0]
    prune = ((stats["opacity_accum"][:, 0] < optim["min_opacity"] * demon)
             & (demon > interval * optim["success_threshold"]) & alive)
    return torch.cat(new_xyz), torch.cat(new_feat), prune
