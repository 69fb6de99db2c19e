"""Anchor densification with fixed shapes (counterpart of
``gscream_tpu/model/densify.py``; the reference's shape-mutating
densification, scene/gaussian_model.py:730-973).

Anchors live in capacity-padded arrays with an ``alive`` mask: growth
writes into free slots and pruning clears mask bits.

* statistics (``training_statis`` gaussian_model.py:730-757): per anchor,
  opacity sums and visit counts over the views where it is visible; per
  offset, the screen-space gradient norms (in the reference's NDC units —
  the caller applies the ×0.5·W/H factors of backward.cu:592-593) and
  their counts;
* growing (``anchor_growing`` 808-911): ``update_depth`` levels with the
  threshold ``grad_thr·(hier//2)^i``, a random keep ``> 0.5^(i+1)``, the
  voxel size ``voxel·(init_factor // hier^i)``, candidates deduplicated
  among themselves and against the alive anchors on exact int32 voxel
  coordinates, features from the max over each voxel's candidates, new
  scales ``log(cur_size)``, opacity/uncertainty logits σ⁻¹(0.1);
* pruning (``adjust_anchor`` 937-971) and the reference's clamp of the
  log-scales ``[:, 3:]`` at 0.05 (gaussian_model.py:776-788);
* candidates that find no free slot are counted in ``grow_overflow``.

:func:`adjust_anchors` keeps the JAX function's operations one for one
(``round`` is half-to-even in both), so ``alive``, the voxel coordinates
and the statistics come out bit-equal to JAX's for the same keep draws;
the float parameters and moments within an ulp (``log`` of the voxel
size, σ⁻¹(0.1)).  The keep draws are made by :func:`keep_draw` alone.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from .scaffold import AnchorParams, ScaffoldConfig, ScaffoldState, \
    inverse_sigmoid

SENTINEL = 2 ** 30      # the sort key of a non-candidate (densify.py:147)


class DensifyStats(NamedTuple):
    opacity_accum: torch.Tensor      # (C,1)
    anchor_demon: torch.Tensor       # (C,1) visit counts
    offset_grad_accum: torch.Tensor  # (C,k)
    offset_denom: torch.Tensor       # (C,k)
    grow_overflow: torch.Tensor      # () int32: candidates dropped for space


# the fields with a row per anchor slot
PER_ANCHOR_STATS = ("opacity_accum", "anchor_demon", "offset_grad_accum",
                    "offset_denom")


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


def keep_draw(generator: torch.Generator, n: int, level: int,
              device) -> torch.Tensor:
    """The ``n`` uniform draws of densification level ``level``'s random
    keep (JAX: ``jax.random.uniform(sub, (CK,))`` with ``sub`` the level's
    split of the densification key, densify.py:133-141).  The one place
    :func:`adjust_anchors` draws random numbers, so that a test can feed
    JAX's draws in its place."""
    del level           # the generator's stream carries the levels
    return torch.rand(n, generator=generator, device=device)


def _voxel_keys(coords: torch.Tensor):
    """(N,3) int32 voxel coords → three exact lexicographic int32 keys
    (densify.py:79-87): no packing, no clamp."""
    return coords[:, 0], coords[:, 1], coords[:, 2]


def _lex_sort(k1, k2, k3) -> torch.Tensor:
    """Stable lexicographic order by (k1, k2, k3): the permutation."""
    o = torch.argsort(k3, stable=True)
    o = o[torch.argsort(k2[o], stable=True)]
    return o[torch.argsort(k1[o], stable=True)]


def _voxel_coords(xyz: torch.Tensor, size: float) -> torch.Tensor:
    """round(xyz / size) as int32.  XLA compiles the JAX function's
    division by the constant voxel size into a product with its float32
    reciprocal; the product is kept here, or a coordinate at a .5 tie
    rounds the other way."""
    inv = float(np.float32(1.0) / np.float32(size))
    return torch.round(xyz * inv).to(torch.int32)


@torch.no_grad()
def adjust_anchors(state: ScaffoldState, stats: DensifyStats,
                   m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor],
                   generator, cfg: ScaffoldConfig,
                   check_interval: float = 100,
                   success_threshold: float = 0.8,
                   grad_threshold: float = 2e-4,
                   min_opacity: float = 0.005):
    """Growing + pruning (densify.py:97-271).  Returns (state, stats, m,
    v): new parameter tensors (the old ones are left as they were), and
    the moment dicts with the ``params/*`` moments of newborn slots zeroed
    (the JAX loop passes ``(m[0], v[0])``, loop.py:528; the decoder
    moments are carried as they are).  ``generator`` is handed to
    :func:`keep_draw`, once per level.  Nothing here reads a value back to
    the host."""
    p = state.params
    dev = state.alive.device
    C, k = cfg.capacity, cfg.n_offsets
    CK = C * k
    F = p.feat.shape[1]

    grads = stats.offset_grad_accum / torch.clamp_min(stats.offset_denom,
                                                      1e-12)
    grads = torch.where(stats.offset_denom > 0, grads, 0.0).reshape(CK)
    offset_mask = (stats.offset_denom
                   > check_interval * success_threshold * 0.5).reshape(CK)
    offset_mask = offset_mask & state.alive.repeat_interleave(k)

    # candidate positions for every (anchor, offset)
    extent = torch.exp(p.scaling[:, :3])
    cand_xyz = (p.anchor[:, None, :] + p.offset * extent[:, None, :]
                ).reshape(CK, 3)

    alive = state.alive
    new = p._asdict()
    m, v = dict(m), dict(v)
    overflow = stats.grow_overflow
    feat_rep = p.feat.repeat_interleave(k, dim=0)          # (CK, F)
    sentinel = torch.tensor(SENTINEL, dtype=torch.int32, device=dev)
    rot0 = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    logit = float(np.float32(inverse_sigmoid(0.1)))

    for level in range(cfg.update_depth):
        cur_threshold = grad_threshold * (
            (cfg.update_hierachy_factor // 2) ** level)
        size_factor = cfg.update_init_factor // (
            cfg.update_hierachy_factor ** level)
        cur_size = cfg.voxel_size * size_factor

        cand = (grads >= cur_threshold) & offset_mask
        rand_keep = keep_draw(generator, CK, level, dev) > (
            0.5 ** (level + 1))
        cand = cand & rand_keep

        coords = _voxel_coords(cand_xyz, cur_size)
        k1, k2, k3 = _voxel_keys(coords)
        # non-candidates sort to the end under the sentinel key
        k1 = torch.where(cand, k1, sentinel)
        order = _lex_sort(k1, k2, k3)
        k1s, k2s, k3s = k1[order], k2[order], k3[order]
        feat_s = feat_rep[order]
        same_as_prev = torch.cat([
            torch.zeros(1, dtype=torch.bool, device=dev),
            (k1s[1:] == k1s[:-1]) & (k2s[1:] == k2s[:-1])
            & (k3s[1:] == k3s[:-1])])
        is_cand = k1s < SENTINEL
        first = is_cand & ~same_as_prev
        # feature per unique voxel: the max over its group (scatter_max,
        # gaussian_model.py:874); empty groups stay -inf and become 0
        group = torch.cumsum(first.to(torch.int32), 0) - 1
        group = torch.where(is_cand, torch.clamp_min(group, 0), CK - 1)
        src_f = torch.where(is_cand[:, None], feat_s, -torch.inf)
        feat_max = torch.full((CK, F), -torch.inf, device=dev).scatter_reduce(
            0, group[:, None].expand(CK, F).long(), src_f, "amax")
        feat_max = torch.where(torch.isfinite(feat_max), feat_max, 0.0)
        feat_vals = feat_max[group.long()]

        # dedup against the alive anchors on the same grid: a binary
        # search over their sorted keys, three int32 keys compared
        # lexicographically (torch.searchsorted takes one key)
        ex = _voxel_coords(new["anchor"], cur_size)
        e1, e2, e3 = _voxel_keys(ex)
        e1 = torch.where(alive, e1, sentinel)
        eorder = _lex_sort(e1, e2, e3)
        e1s, e2s, e3s = e1[eorder], e2[eorder], e3[eorder]
        lo = torch.zeros(CK, dtype=torch.int64, device=dev)
        hi = torch.full((CK,), C, dtype=torch.int64, device=dev)
        for _ in range(C.bit_length()):
            mid = (lo + hi) // 2
            midc = torch.clamp(mid, 0, C - 1)
            a1, a2, a3 = e1s[midc], e2s[midc], e3s[midc]
            less = ((a1 < k1s) | ((a1 == k1s) & (a2 < k2s))
                    | ((a1 == k1s) & (a2 == k2s) & (a3 < k3s)))
            lo = torch.where(less, mid + 1, lo)
            hi = torch.where(less, hi, mid)
        loc = torch.clamp(lo, 0, C - 1)
        dup = ((lo < C) & (e1s[loc] == k1s) & (e2s[loc] == k2s)
               & (e3s[loc] == k3s))
        survivor = first & ~dup

        # compact the survivors into free slots, in sorted order; slot CK
        # absorbs the non-survivors' (zero) writes
        surv_rank = torch.cumsum(survivor.to(torch.int32), 0) - 1
        n_surv = torch.sum(survivor.to(torch.int32))
        dst = torch.where(survivor, surv_rank, CK).long()
        by_rank_coord = torch.zeros((CK + 1, 3), dtype=torch.int32,
                                    device=dev).index_copy_(
            0, dst, torch.where(survivor[:, None], coords[order], 0))
        by_rank_feat = torch.zeros((CK + 1, F), device=dev).index_copy_(
            0, dst, torch.where(survivor[:, None], feat_vals, 0.0))

        free = ~alive
        free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
        n_free = torch.sum(free.to(torch.int32))
        take = free & (free_rank < n_surv)
        src = torch.clamp(torch.where(take, free_rank, CK), 0, CK).long()
        overflow = overflow + torch.clamp_min(n_surv - n_free, 0)

        t1 = take[:, None]
        log_size = torch.log(torch.tensor(cur_size, dtype=torch.float32,
                                          device=dev))
        new = dict(
            anchor=torch.where(t1, by_rank_coord[src].to(torch.float32)
                               * cur_size, new["anchor"]),
            offset=torch.where(take[:, None, None], 0.0, new["offset"]),
            feat=torch.where(t1, by_rank_feat[src], new["feat"]),
            scaling=torch.where(t1, log_size, new["scaling"]),
            rotation=torch.where(t1, rot0, new["rotation"]),
            opacity=torch.where(t1, logit, new["opacity"]),
            uncertainty=torch.where(t1, logit, new["uncertainty"]))
        # zero the Adam moments of newborn slots (params/* only)
        for f in AnchorParams._fields:
            key = f"params/{f}"
            shape = (C,) + (1,) * (m[key].dim() - 1)
            m[key] = torch.where(take.reshape(shape), 0.0, m[key])
            v[key] = torch.where(take.reshape(shape), 0.0, v[key])
        alive = alive | take

    # --- pruning (gaussian_model.py:937-971)
    prune = (stats.opacity_accum < min_opacity * stats.anchor_demon)[:, 0]
    observed = (stats.anchor_demon > check_interval * success_threshold)[:, 0]
    prune = prune & observed & state.alive
    alive = alive & ~prune

    # the clamp of the log-scales [:, 3:] at 0.05 (gaussian_model.py:776)
    scaling = new["scaling"].clone()
    scaling[:, 3:] = torch.clamp_max(scaling[:, 3:], 0.05)
    new["scaling"] = scaling

    # statistics: observed anchors restart, offsets that were candidates
    # restart, pruned slots clear
    reset_a = (observed | prune)[:, None]
    reset_o = offset_mask.reshape(C, k) | prune[:, None]
    new_stats = DensifyStats(
        opacity_accum=torch.where(reset_a, 0.0, stats.opacity_accum),
        anchor_demon=torch.where(reset_a, 0.0, stats.anchor_demon),
        offset_grad_accum=torch.where(reset_o, 0.0,
                                      stats.offset_grad_accum),
        offset_denom=torch.where(reset_o, 0.0, stats.offset_denom),
        grow_overflow=overflow.to(torch.int32))
    new_state = state._replace(params=AnchorParams(**new), alive=alive)
    return new_state, new_stats, m, v
