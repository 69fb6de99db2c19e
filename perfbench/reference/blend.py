"""Per-pixel front-to-back alpha blending (the 3D Gaussian Splatting
rasterizer's ``renderCUDA``, extended by GScream to depth and
uncertainty), in plain PyTorch, one group of 32×32 tiles at a time.

A pixel sees the gaussians whose tile rectangle (``getRect`` of the 3σ
radius) holds its tile, in ascending view depth (a stable order: equal
depths keep the gaussians' index order).  For each, α = min(0.99,
o·exp(power)) with power = −½(a·dx² + c·dy²) − b·dx·dy; a gaussian with
power > 0 or α < 1/255 is skipped; the blend stops, without that
gaussian, at the first one that would take the transmittance below
1e-4.  Colour, depth and uncertainty are the weighted sums with weights
α·T, and the final transmittance composites the background.

To keep the tiles' lists short, a gaussian is listed only on the tiles
that also meet the bounding box of its α ≥ 1/255 ellipse (widened by a
pixel): every pair this drops has α < 1/255 and would be skipped.

Departure, as in the published rasterizer's backward: the gradient of α
ignores the 0.99 clamp (straight through).
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

TILE = 32
PIX = TILE * TILE
ALPHA_MIN = 1.0 / 255.0
T_STOP = 1e-4
# (tile, pixel, instance) elements blended at once: the group size
PAIR_BUDGET = 1 << 24


def clamp_alpha(x):
    return x + (torch.clamp_max(x, 0.99) - x).detach()


class Bins(NamedTuple):
    gid: torch.Tensor        # (I,) gaussian of each instance, sorted by
                             # (tile, depth)
    start: torch.Tensor      # (n_tiles,) first instance of each tile
    count: torch.Tensor      # (n_tiles,)
    groups: List[torch.Tensor]   # tile ids blended together
    gx: int
    gy: int


@torch.no_grad()
def bin_tiles(mean2d, cov2d, opacity, depth, radius, width, height) -> Bins:
    gx, gy = -(-width // TILE), -(-height // TILE)
    mx, my = mean2d[:, 0], mean2d[:, 1]
    x0 = torch.floor((mx - radius) / TILE).clamp(0, gx)
    y0 = torch.floor((my - radius) / TILE).clamp(0, gy)
    x1 = torch.floor((mx + radius + TILE - 1) / TILE).clamp(0, gx)
    y1 = torch.floor((my + radius + TILE - 1) / TILE).clamp(0, gy)
    t = torch.log(255.0 * torch.clamp_min(opacity, 1e-12))
    tpos = torch.clamp_min(t, 0.0)
    hx = torch.sqrt(2.0 * tpos * torch.clamp_min(cov2d[:, 0], 0.0)) + 1.0
    hy = torch.sqrt(2.0 * tpos * torch.clamp_min(cov2d[:, 2], 0.0)) + 1.0
    x0 = torch.maximum(x0, torch.floor((mx - hx) / TILE))
    y0 = torch.maximum(y0, torch.floor((my - hy) / TILE))
    x1 = torch.minimum(x1, torch.floor((mx + hx) / TILE) + 1)
    y1 = torch.minimum(y1, torch.floor((my + hy) / TILE) + 1)
    wx = torch.clamp_min(x1 - x0, 0).long()
    wy = torch.clamp_min(y1 - y0, 0).long()
    n = torch.where((radius > 0) & (t > 0), wx * wy, torch.zeros_like(wx))
    ids = torch.nonzero(n > 0).squeeze(1)
    n = n[ids]
    gid = torch.repeat_interleave(ids, n)
    first = torch.cumsum(n, 0) - n
    j = torch.arange(gid.shape[0], device=gid.device) - \
        torch.repeat_interleave(first, n)
    w = wx[gid]
    tile = (y0[gid].long() + j // w) * gx + x0[gid].long() + j % w
    order = torch.argsort(depth[gid], stable=True)
    order = order[torch.argsort(tile[order], stable=True)]
    gid, tile = gid[order], tile[order]
    count = torch.bincount(tile, minlength=gx * gy)
    start = torch.cumsum(count, 0) - count
    # groups of tiles, longest lists first, of at most PAIR_BUDGET pairs
    cnt = count.tolist()
    by_len = sorted((c, i) for i, c in enumerate(cnt) if c > 0)[::-1]
    groups, cur, cur_len = [], [], 0
    for c, i in by_len:
        if cur and (len(cur) + 1) * PIX * cur_len > PAIR_BUDGET:
            groups.append(cur)
            cur = []
        if not cur:
            cur_len = c
        cur.append(i)
    if cur:
        groups.append(cur)
    dev = mean2d.device
    return Bins(gid, start, count,
                [torch.tensor(g, device=dev) for g in groups], gx, gy)


def _group_pairs(bins: Bins, tiles):
    """(gaussian ids (B,L), slot valid (B,L), pixel x, y (B,PIX))."""
    cnt = bins.count[tiles]
    L = max(int(cnt.max()), 1)
    slot = torch.arange(L, device=tiles.device)
    valid = slot[None, :] < cnt[:, None]
    idx = torch.clamp_max(bins.start[tiles][:, None] + slot[None, :],
                          max(bins.gid.shape[0] - 1, 0))
    gid = bins.gid[idx]
    p = torch.arange(PIX, device=tiles.device)
    px = ((tiles % bins.gx) * TILE)[:, None] + (p % TILE)[None, :]
    py = ((tiles // bins.gx) * TILE)[:, None] + (p // TILE)[None, :]
    return gid, valid, px.float(), py.float()


def _alphas(mean2d, conic, opacity, gid, valid, px, py):
    m = mean2d[gid]
    con = conic[gid]
    dx = m[:, None, :, 0] - px[:, :, None]
    dy = m[:, None, :, 1] - py[:, :, None]
    power = (-0.5 * (con[:, None, :, 0] * dx * dx
                     + con[:, None, :, 2] * dy * dy)
             - con[:, None, :, 1] * dx * dy)
    # exp of a positive power (a skipped pair) is kept finite, so that no
    # inf reaches the backward through the masked lanes
    alpha = clamp_alpha(opacity[gid][:, None, :]
                        * torch.exp(torch.clamp_max(power, 0.0)))
    ok = valid[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    a = torch.where(ok, alpha, torch.zeros_like(alpha))
    return a, ok


def _blend_group(g, bins: Bins, tiles):
    """(colour (B,PIX,3), depth (B,PIX), unc (B,PIX), T (B,PIX)) of a tile
    group from per-gaussian ``g = (mean2d, conic, opacity, colour, depth,
    unc)``."""
    mean2d, conic, opacity, color, depth, unc = g
    gid, valid, px, py = _group_pairs(bins, tiles)
    a, ok = _alphas(mean2d, conic, opacity, gid, valid, px, py)
    keep = 1.0 - a
    p_inc = torch.cumprod(keep, dim=2)
    p_exc = torch.cat([torch.ones_like(p_inc[..., :1]), p_inc[..., :-1]], 2)
    applied = ok & (p_inc >= T_STOP)
    w = torch.where(applied, a * p_exc, torch.zeros_like(a))
    C = torch.bmm(w, color[gid])
    D = torch.bmm(w, depth[gid][..., None])[..., 0]
    U = torch.bmm(w, unc[gid][..., None])[..., 0]
    T = torch.prod(torch.where(applied, keep, torch.ones_like(keep)), 2)
    return C, D, U, T


def _canvas(bins: Bins, parts, shape_tail, fill, dev):
    out = torch.full((bins.gx * bins.gy, PIX) + shape_tail, fill,
                     device=dev)
    for tiles, val in parts:
        out[tiles] = val
    g = out.reshape((bins.gy, bins.gx, TILE, TILE) + shape_tail)
    return g.transpose(1, 2).reshape((bins.gy * TILE, bins.gx * TILE)
                                     + shape_tail)


def render(g, bins: Bins, width, height, bg):
    """The blended image (H,W,3) with the background composited, depth,
    uncertainty and final transmittance (H,W), without gradient."""
    dev = g[0].device
    parts = []
    with torch.no_grad():
        for tiles in bins.groups:
            parts.append((tiles, _blend_group(g, bins, tiles)))
    C = _canvas(bins, [(t, p[0]) for t, p in parts], (3,), 0.0, dev)
    D = _canvas(bins, [(t, p[1]) for t, p in parts], (), 0.0, dev)
    U = _canvas(bins, [(t, p[2]) for t, p in parts], (), 0.0, dev)
    T = _canvas(bins, [(t, p[3]) for t, p in parts], (), 1.0, dev)
    C, D, U, T = (x[:height, :width] for x in (C, D, U, T))
    return C + T[..., None] * bg, D, U, T


def _tiles_of(img, bins: Bins, tiles):
    """The (B, PIX, ...) pixels of ``tiles`` from an (H,W,...) image,
    zero-padded to the tile grid."""
    H, W = img.shape[:2]
    full = img.new_zeros((bins.gy * TILE, bins.gx * TILE) + img.shape[2:])
    full[:H, :W] = img
    g = full.reshape((bins.gy, TILE, bins.gx, TILE) + img.shape[2:])
    g = g.transpose(1, 2).reshape((bins.gy * bins.gx, PIX) + img.shape[2:])
    return g[tiles]


def render_vjp(g, bins: Bins, d_color, d_depth, d_unc=None):
    """The gradient of ⟨d_color, colour⟩ + ⟨d_depth, depth⟩ (+ ⟨d_unc,
    unc⟩) with respect to each tensor of ``g``, the tile groups blended
    again with autograd one at a time."""
    leaves = [x.detach().requires_grad_() for x in g]
    for tiles in bins.groups:
        C, D, U, _ = _blend_group(leaves, bins, tiles)
        outs = [C, D]
        grads = [_tiles_of(d_color, bins, tiles),
                 _tiles_of(d_depth, bins, tiles)]
        if d_unc is not None:
            outs.append(U)
            grads.append(_tiles_of(d_unc, bins, tiles))
        torch.autograd.backward(outs, grads)
    return [x.grad if x.grad is not None else torch.zeros_like(x)
            for x in leaves]


@torch.no_grad()
def blended_work(g, bins: Bins):
    """What the mathematics of the blend asks on this view: ``pairs``, the
    (instance, pixel) pairs blended (α ≥ 1/255 before the pixel's stop);
    ``instances``, the instances blended at one pixel or more; ``pixels``,
    the pixels of the tiles that hold any instance."""
    mean2d, conic, opacity = g[0], g[1], g[2]
    pairs = inst = 0
    for tiles in bins.groups:
        gid, valid, px, py = _group_pairs(bins, tiles)
        a, ok = _alphas(mean2d, conic, opacity, gid, valid, px, py)
        applied = ok & (torch.cumprod(1.0 - a, 2) >= T_STOP)
        pairs += int(applied.sum())
        inst += int(applied.any(1).sum())
    return {"pairs": pairs, "instances": inst,
            "pixels": PIX * int((bins.count > 0).sum()),
            "tiles": bins.gx * bins.gy}

