"""One phase-1 training iteration: decode → rasterize → losses → Adam
(counterpart of ``gscream_tpu/train/step.py``).

Functional equivalent of one iteration of the reference training loop
(``train.py:390-616``) without cross-attention:

1. prefilter anchors for visibility (the densification statistics);
2. decode neural gaussians, preprocess, bin (no gradient), rasterize
   colour, depth and uncertainty through K1 and its backward K2-K4;
3. masked RGB + scale/shift depth losses (train.py:535-573);
4. one masked Adam step with per-group learning rates (in place) and the
   densification statistics.

The screen-space gradient for densification is taken as the JAX package
takes it: a zero (C·k, 2) leaf that requires grad is added to the
projected means, and its gradient read back (the reference's
``screenspace_points`` retain_grad trick,
gaussian_renderer/__init__.py:124-128).  Phase 2 (``crossattn_update``,
``sample_cross_tokens``) is not ported yet and raises.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
from torch.profiler import record_function

from ..cameras import Camera
from ..config import OptimConfig
from ..model.densify import accumulate_stats
from ..model.scaffold import Decoded, ScaffoldConfig, ScaffoldState, decode
from ..ops import losses as L
from ..ops.binning import Binning, bin_instances, overflow_demand
from ..ops.projection import Splats, preprocess
from ..ops.rasterize_tiled import TILE_H, TILE_W, rasterize_tiled
from ..ops.ssim import ssim, ssim_masked
from .state import TrainState, apply_adam, group_of, lr_tree, named_params


class StepAux(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    num_instances: torch.Tensor   # overflow_demand of the binning
    n_active: torch.Tensor
    cross_ok: torch.Tensor
    # (5,) float32 [loss, l1, num_instances, n_active, cross_ok]: one
    # array for the host to fetch per step (counts exact below 2^24)
    packed: torch.Tensor = None


def pack_aux(loss, l1, num_instances, n_active, cross_ok) -> StepAux:
    f = torch.float32
    packed = torch.stack([loss.to(f), l1.to(f), num_instances.to(f),
                          n_active.to(f), cross_ok.to(f)])
    return StepAux(loss=loss, l1=l1, num_instances=num_instances,
                   n_active=n_active, cross_ok=cross_ok, packed=packed)


def render_from_params(params, mlps, scaffold: ScaffoldState, camera: Camera,
                       bg, screen_zero, cfg: ScaffoldConfig, capacity: int):
    """Decode + rasterize from explicit (differentiable) parameters;
    returns (TiledOut, Decoded, Splats, Binning).  The binning runs under
    ``torch.no_grad()`` (the JAX ``stop_gradient``, rasterize_tiled.py:
    1276-1277): gradients reach the gaussians only through the
    rasterizer's own arguments."""
    st = scaffold._replace(params=params, mlps=mlps)
    w, h = camera.width, camera.height
    with record_function("step/decode"):
        dec = decode(st, camera.cam_center, None, cfg)
    with record_function("step/preprocess"):
        splats = preprocess(
            dec.xyz, dec.scale, dec.rot, camera.w2c, camera.full_proj, w, h,
            camera.tan_fovx, camera.tan_fovy, tile_w=TILE_W, tile_h=TILE_H,
            active_mask=dec.active, opacity=dec.opacity)
        mean2d = splats.mean2d + screen_zero
    with record_function("step/binning"), torch.no_grad():
        binning = bin_instances(splats, capacity, w, h, TILE_W, TILE_H)
    with record_function("step/forward"):
        out = rasterize_tiled(mean2d, splats.conic, dec.opacity, dec.color,
                              splats.depth, dec.uncertainty, binning, bg, w,
                              h)
    return out, dec, splats, binning


def loss_terms(out, gt_image, gt_mask, midas_depth, fg_box_mask,
               opt: OptimConfig, is_ref: bool):
    """RGB + depth losses (train.py:535-573).  Images are (C,H,W)."""
    if opt.loss_dtype != "float32":
        raise NotImplementedError(
            f"loss_dtype={opt.loss_dtype!r}: only the float32 loss path "
            "is ported")
    img = out.color.permute(2, 0, 1)
    if is_ref:
        l1 = L.l1_loss(img, gt_image)
        loss = opt.refer_rgb_lr * ((1 - opt.lambda_dssim) * l1
                                   + opt.lambda_dssim
                                   * (1 - ssim(img, gt_image)))
        if opt.refer_rgb_lr_fg > opt.refer_rgb_lr:
            loss = loss + (opt.refer_rgb_lr_fg - opt.refer_rgb_lr) * (
                (1 - opt.lambda_dssim)
                * L.l1_loss_masked(img, gt_image, gt_mask)
                + opt.lambda_dssim
                * (1 - ssim_masked(img, gt_image, gt_mask)))
        if opt.refer_depth_lr > 0:
            loss = loss + L.depth_loss_ref(
                out.depth, midas_depth[0], gt_mask[0], fg_box_mask,
                opt.refer_depth_lr, opt.refer_depth_lr_fg,
                opt.refer_depth_lr_smooth)
    else:
        w = (1.0 - gt_mask) + opt.other_rgb_lr_fg * gt_mask
        l1 = L.l1_loss_masked(img, gt_image, w)
        loss = opt.other_rgb_lr * ((1 - opt.lambda_dssim) * l1
                                   + opt.lambda_dssim
                                   * (1 - ssim_masked(img, gt_image, w)))
        if opt.other_depth_lr > 0:
            loss = loss + L.depth_loss_other(
                out.depth, midas_depth[0], gt_mask[0],
                opt.other_depth_lr, opt.other_depth_lr_smooth)
    return loss, l1


def phase1_masks(feat_frozen: bool):
    """Which optimizer groups the phase-1 Adam updates (step.py:308-313):
    rotation, opacity and uncertainty are frozen, the cross-attention
    group has its own optimizer, and ``feat_frozen`` reproduces the
    reference's permanent detach of the anchor features once
    cross-attention has run."""
    return {
        "params/anchor": True, "params/offset": True,
        "params/feat": not feat_frozen, "params/scaling": True,
        "params/rotation": False, "params/opacity": False,
        "params/uncertainty": False,
        "mlps/opacity": True, "mlps/uncertainty": True, "mlps/cov": True,
        "mlps/color": True, "mlps/crossattn": False,
        "mlps/feat_bank": True,
    }


def train_step(ts: TrainState, camera: Camera, gt_image, gt_mask,
               midas_depth, fg_box_mask, cross_box=None, *,
               cfg: ScaffoldConfig, opt: OptimConfig, is_ref: bool,
               use_crossattn: bool = False, capacity: int, width: int,
               height: int, accumulate: bool, white_bg: bool = False,
               spatial_lr_scale: float = 1.0, feat_frozen: bool = False):
    """One optimization iteration.  Returns (new_state, StepAux); the
    parameters and moments are updated in place, so ``ts`` itself holds
    the new values too.

    gt_image (3,H,W) · gt_mask (1,H,W) · midas_depth (1,H,W) ·
    fg_box_mask (H,W) random box for the ref-view fg depth term ·
    cross_box (4,) the phase-2 patch (unused in phase 1).
    """
    if use_crossattn:
        raise NotImplementedError(
            "phase-2 cross-attention (crossattn_update, "
            "sample_cross_tokens) is not ported yet")
    if (camera.width, camera.height) != (width, height):
        raise ValueError(f"camera is {camera.width}x{camera.height}, the "
                         f"step was asked for {width}x{height}")
    scaffold = ts.scaffold
    dev = scaffold.alive.device
    C, k = cfg.capacity, cfg.n_offsets
    step1 = ts.step + 1
    p = scaffold.params

    # --- prefilter: anchor visibility (densification statistics) -------
    with record_function("step/prefilter"), torch.no_grad():
        pre = preprocess(
            p.anchor, torch.exp(p.scaling[:, :3]),
            p.rotation / torch.clamp_min(torch.linalg.vector_norm(
                p.rotation, dim=1, keepdim=True), 1e-12),
            camera.w2c, camera.full_proj, width, height, camera.tan_fovx,
            camera.tan_fovy, tile_w=TILE_W, tile_h=TILE_H,
            active_mask=scaffold.alive)
        anchor_visible = (pre.radius > 0) & scaffold.alive

    masks = phase1_masks(feat_frozen)
    g = loss_and_grads(scaffold, camera, gt_image, gt_mask, midas_depth,
                       fg_box_mask, cfg=cfg, opt=opt, is_ref=is_ref,
                       capacity=capacity, masks=masks, white_bg=white_bg)

    # --- densification stats (training_statis, train.py:599) ------------
    stats = ts.stats
    if accumulate:
        with torch.no_grad():
            # screen grads in the reference's NDC units (backward.cu:592)
            ndc = g.screen * torch.tensor([0.5 * width, 0.5 * height],
                                          device=dev)
            grad_norm = torch.linalg.vector_norm(ndc, dim=1).reshape(C, k)
            gauss_valid = (g.dec.active
                           & (g.splats.radius > 0)).reshape(C, k)
            stats = accumulate_stats(stats, g.dec.neural_opacity.detach(),
                                     grad_norm, gauss_valid, anchor_visible)

    # --- masked Adam, in place ------------------------------------------
    with record_function("step/adam"):
        apply_adam(named_params(scaffold), g.grads, ts.m, ts.v,
                   lr_tree(step1, opt, spatial_lr_scale), step1, masks)

    with torch.no_grad():
        aux = pack_aux(g.loss.detach(), g.l1.detach(),
                       overflow_demand(g.binning),
                       torch.sum(g.dec.active.to(torch.int32)),
                       torch.zeros((), dtype=torch.bool, device=dev))
    return ts._replace(step=step1, stats=stats), aux


class StepGrads(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    grads: Dict[str, torch.Tensor]  # named_params key → gradient, for
                                    # the groups the masks update
    screen: torch.Tensor     # (C·k, 2) gradient of the projected means
    dec: Decoded
    splats: Splats
    binning: Binning


def loss_and_grads(scaffold: ScaffoldState, camera: Camera, gt_image,
                   gt_mask, midas_depth, fg_box_mask, *, cfg: ScaffoldConfig,
                   opt: OptimConfig, is_ref: bool, capacity: int, masks,
                   white_bg: bool = False) -> StepGrads:
    """The phase-1 loss of one view and its gradients with respect to the
    parameters of every group that ``masks`` updates and to the projected
    means (``value_and_grad`` of ``loss_fn``, step.py:255-274)."""
    dev = scaffold.alive.device
    bg = (torch.ones(3, device=dev) if white_bg
          else torch.zeros(3, device=dev))
    p = scaffold.params
    anchor = type(p)(*(t.detach().requires_grad_() for t in p))
    screen_zero = torch.zeros((cfg.capacity * cfg.n_offsets, 2),
                              device=dev, requires_grad=True)
    out, dec, splats, binning = render_from_params(
        anchor, scaffold.mlps, scaffold, camera, bg, screen_zero, cfg,
        capacity)
    with record_function("step/losses"):
        loss, l1 = loss_terms(out, gt_image, gt_mask, midas_depth,
                              fg_box_mask, opt, is_ref)
    # the autograd leaves: the fresh anchor tensors and the MLP weights
    leaves = {name: (getattr(anchor, name[len("params/"):])
                     if name.startswith("params/") else t)
              for name, t in named_params(scaffold).items()
              if masks[group_of(name)]}
    with record_function("step/backward"):
        grads = torch.autograd.grad(
            loss, list(leaves.values()) + [screen_zero], allow_unused=True)
    return StepGrads(
        loss=loss, l1=l1, screen=grads[-1], dec=dec, splats=splats,
        binning=binning,
        grads={name: torch.zeros_like(t) if g is None else g
               for (name, t), g in zip(leaves.items(), grads[:-1])})
