"""Oracle rasterizer in plain PyTorch (counterpart of
``gscream_tpu/ops/rasterize_ref.py``) — slow but exact, no kernel.

Two forms of the reference's front-to-back alpha compositing
(``cuda_rasterizer/forward.cu:441-568`` ``renderCUDA``):

* :func:`rasterize_sequential` — a loop over depth-sorted gaussians
  carrying per-pixel transmittance, the CUDA loop term for term
  (including the ``done`` early stop); tiny problems only.
* :func:`rasterize_scan` — the prefix-product form: with α'_i = α_i where
  the power and 1/255 tests pass (else 0) and P_i = Π_{j≤i}(1−α'_j),
  ``applied_i = (P_i ≥ 1e-4) ∧ (α'_i > 0)``, ``w_i = applied_i · α_i ·
  P^exc_i``, ``C = Σ w_i c_i`` and ``T = min_i(P_i if P_i ≥ 1e-4 else
  1)``: a cumulative sum of log(1−α') and two reductions (the derivation
  is in the JAX module's docstring).  It makes the synthetic scene's
  targets (``data/synthetic.py``).

Both render colour (3), depth and uncertainty and return the final
transmittance (forward.cu:545-566).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .projection import ALPHA_MIN, T_STOP, Splats, clamp_alpha


class RenderOut(NamedTuple):
    color: torch.Tensor        # (H,W,3)
    depth: torch.Tensor        # (H,W)
    uncertainty: torch.Tensor  # (H,W)
    final_t: torch.Tensor      # (H,W) final transmittance
    n_contrib: Optional[torch.Tensor] = None  # (H,W) int32, sequential only


def _pixel_grid(width: int, height: int, device):
    px = torch.arange(width, dtype=torch.float32, device=device)
    py = torch.arange(height, dtype=torch.float32, device=device)
    ys, xs = torch.meshgrid(py, px, indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)          # each (H·W,)


def _depth_order(splats: Splats) -> torch.Tensor:
    """Global stable depth order with culled gaussians last (the
    reference's radix sort over (tile, depth) keys, rasterizer_impl.cu:
    306-314, is a stable ascending sort for non-negative depths)."""
    key = torch.where(splats.radius > 0, splats.depth, torch.inf)
    return torch.argsort(key, stable=True)


def _sorted(splats: Splats, colors, opacities, uncertainties):
    order = _depth_order(splats)
    s = Splats(*((x[order] if x is not None else None) for x in splats))
    return s, colors[order], opacities[order], uncertainties[order]


def rasterize_sequential(splats: Splats, colors, opacities, uncertainties,
                         bg, width: int, height: int, tile_w: int = 16,
                         tile_h: int = 16) -> RenderOut:
    """The CUDA blend loop, one gaussian at a time (oracle only)."""
    s, colors, opacities, uncertainties = _sorted(splats, colors, opacities,
                                                  uncertainties)
    px, py = _pixel_grid(width, height, colors.device)
    P = px.shape[0]
    tx = torch.div(px, tile_w, rounding_mode="floor").to(torch.int32)
    ty = torch.div(py, tile_h, rounding_mode="floor").to(torch.int32)
    T = torch.ones(P, device=px.device)
    done = torch.zeros(P, dtype=torch.bool, device=px.device)
    C = torch.zeros((P, 3), device=px.device)
    D = torch.zeros(P, device=px.device)
    U = torch.zeros(P, device=px.device)
    n = torch.zeros(P, dtype=torch.int32, device=px.device)
    idx = torch.zeros(P, dtype=torch.int32, device=px.device)
    for i in range(s.mean2d.shape[0]):
        mean, con = s.mean2d[i], s.conic[i]
        dx = mean[0] - px
        dy = mean[1] - py
        power = (-0.5 * (con[0] * dx * dx + con[2] * dy * dy)
                 - con[1] * dx * dy)
        alpha = clamp_alpha(opacities[i] * torch.exp(power))
        rmin, rmax = s.rect_min[i], s.rect_max[i]
        in_rect = ((rmin[0] <= tx) & (tx < rmax[0])
                   & (rmin[1] <= ty) & (ty < rmax[1]))
        seen = (s.radius[i] > 0) & in_rect        # in this pixel's list
        ok = seen & (power <= 0.0) & (alpha >= ALPHA_MIN) & ~done
        test_t = T * (1.0 - alpha)
        stop = ok & (test_t < T_STOP)
        apply = ok & ~stop
        w = torch.where(apply, alpha * T, 0.0)
        C = C + w[:, None] * colors[i][None, :]
        D = D + w * s.depth[i]
        U = U + w * uncertainties[i]
        T = torch.where(apply, test_t, T)
        done = done | stop
        # n_contrib counts the last applied position in the pixel's list
        idx = idx + seen.to(torch.int32)
        n = torch.where(apply, idx, n)
    C = C + T[:, None] * bg[None, :]
    return RenderOut(color=C.reshape(height, width, 3),
                     depth=D.reshape(height, width),
                     uncertainty=U.reshape(height, width),
                     final_t=T.reshape(height, width),
                     n_contrib=n.reshape(height, width))


def _blend_block(s: Splats, colors, opacities, uncertainties, bg, px, py,
                 tile_w, tile_h):
    """The scan-form blend of a block of pixels: (C (P,3), D, U, T)."""
    dx = s.mean2d[None, :, 0] - px[:, None]               # (P,N)
    dy = s.mean2d[None, :, 1] - py[:, None]
    con = s.conic
    power = (-0.5 * (con[None, :, 0] * dx * dx + con[None, :, 2] * dy * dy)
             - con[None, :, 1] * dx * dy)
    alpha = clamp_alpha(opacities[None, :] * torch.exp(power))
    tx = torch.div(px, tile_w, rounding_mode="floor").to(torch.int32)[:, None]
    ty = torch.div(py, tile_h, rounding_mode="floor").to(torch.int32)[:, None]
    in_rect = ((s.rect_min[None, :, 0] <= tx) & (tx < s.rect_max[None, :, 0])
               & (s.rect_min[None, :, 1] <= ty)
               & (ty < s.rect_max[None, :, 1]))
    valid = ((s.radius[None, :] > 0) & in_rect & (power <= 0.0)
             & (alpha >= ALPHA_MIN))
    alpha_v = torch.where(valid, alpha, 0.0)
    logs = torch.log1p(-alpha_v)
    cum = torch.cumsum(logs, dim=1)
    p_inc = torch.exp(cum)                     # inclusive prefix Π(1-α')
    p_exc = torch.exp(cum - logs)              # exclusive prefix
    applied = valid & (p_inc >= T_STOP)
    w = torch.where(applied, alpha * p_exc, 0.0)          # (P,N)
    C = w @ colors
    D = w @ s.depth
    U = w @ uncertainties
    T = torch.min(torch.where(p_inc >= T_STOP, p_inc, 1.0), dim=1).values
    return C + T[:, None] * bg[None, :], D, U, T


def rasterize_scan(splats: Splats, colors, opacities, uncertainties, bg,
                   width: int, height: int, tile_w: int = 16,
                   tile_h: int = 16, block: int = 4096) -> RenderOut:
    """The prefix-scan rasterizer over all gaussians, ``block`` pixels at
    a time; differentiable end to end (the applied-set decisions frozen,
    as the reference freezes its contributor counts)."""
    s, colors, opacities, uncertainties = _sorted(splats, colors, opacities,
                                                  uncertainties)
    px, py = _pixel_grid(width, height, colors.device)
    parts = [_blend_block(s, colors, opacities, uncertainties, bg,
                          px[i:i + block], py[i:i + block], tile_w, tile_h)
             for i in range(0, px.shape[0], block)]
    C, D, U, T = (torch.cat(x) for x in zip(*parts))
    return RenderOut(color=C.reshape(height, width, 3),
                     depth=D.reshape(height, width),
                     uncertainty=U.reshape(height, width),
                     final_t=T.reshape(height, width))
