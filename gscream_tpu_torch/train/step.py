"""One training iteration: decode → rasterize → losses → Adam
(counterpart of ``gscream_tpu/train/step.py``).

Functional equivalent of one iteration of the reference training loop
(``train.py:390-616``):

1. prefilter anchors for visibility (the densification statistics) and,
   in phase 2, for the foreground/background token sampling;
2. [phase 2] bidirectional cross-attention between sampled foreground
   (mask region) and background anchors, EMA-written into the anchor
   features (``run_crossattn``, gaussian_model.py:553-583; sampling
   train.py:436-513);
3. decode neural gaussians, preprocess, bin (no gradient), rasterize
   colour, depth and uncertainty through K1 and its backward K2-K4;
4. masked RGB + scale/shift depth losses (train.py:535-573);
5. one masked Adam step with per-group learning rates (in place), the
   cross-attention's own Adam in phase 2, and the densification
   statistics.

The screen-space gradient for densification is taken as the JAX package
takes it: a zero (C·k, 2) leaf that requires grad is added to the
projected means, and its gradient read back (the reference's
``screenspace_points`` retain_grad trick,
gaussian_renderer/__init__.py:124-128).

The JAX step is a pure function, and its loop re-runs an overflowed step
from the state it kept.  This one updates in place, and it reads nothing
to the host: it enqueues the whole step (a launch) and gates its writes
on the device.  Where the instance demand exceeds ``capacity`` or the
loss is not finite, the flag ``ok`` is False and the step changes no
parameter, moment, statistic or ``step_c``; the caller sees the step's
five scalars (``StepAux.packed``, copied to host memory without
blocking) when it reads them with :func:`aux_values`, and re-runs the
step at a larger capacity from the state it kept.  The host-side
``step`` count advances at the launch, and a phase-2 step's token draws
advance the generator at the launch too (its state is host data): the
loop puts both back from its snapshot of the state before the step
(``train.state.StatePool``) when it re-runs one.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from ..cameras import Camera
from ..config import OptimConfig
from ..device import device_constant
from ..model.densify import accumulate_stats
from ..model.scaffold import Decoded, ScaffoldConfig, ScaffoldState, decode
from ..ops import losses as L
from ..ops.attention import bidirectional_attn
from ..ops.binning import Binning, overflow_demand
from ..ops.projection import Splats, preprocess
from ..ops.rasterize_tiled import (TILE_H, TILE_W, build_binning,
                                   rasterize_tiled)
from ..ops.ssim import ssim, ssim_masked
from .state import (TrainState, apply_adam, device_bias, group_of, lr_tree,
                    named_params)


class StepAux(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    num_instances: torch.Tensor   # overflow_demand of the binning
    n_active: torch.Tensor
    cross_ok: torch.Tensor
    # (5,) float32 [loss, l1, num_instances, n_active, cross_ok] on the
    # step's device (counts exact below 2^24)
    packed: torch.Tensor = None
    # its copy in (pinned) host memory, and on the card the CUDA event
    # recorded after the copy; read both through aux_values
    host: torch.Tensor = None
    ready: Optional[object] = None


def pack_aux(loss, l1, num_instances, n_active, cross_ok) -> StepAux:
    """The step's five scalars stacked on the device, and on the card a
    non-blocking copy of them into pinned host memory with an event
    after it: nothing here waits for the device."""
    f = torch.float32
    packed = torch.stack([loss.to(f), l1.to(f), num_instances.to(f),
                          n_active.to(f), cross_ok.to(f)])
    host, ready = packed, None
    if packed.is_cuda:
        host = torch.empty(packed.shape, dtype=f, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
    return StepAux(loss=loss, l1=l1, num_instances=num_instances,
                   n_active=n_active, cross_ok=cross_ok, packed=packed,
                   host=host, ready=ready)


def aux_values(aux: StepAux) -> list:
    """``[loss, l1, num_instances, n_active, cross_ok]`` as Python floats:
    the step's one device-to-host read, which waits for the step's copy
    (the loop's ``resolve``)."""
    if aux.ready is not None:
        aux.ready.synchronize()
    return aux.host.tolist()


class CrossTokens(NamedTuple):
    """Phase 2's sampled tokens (``sample_cross_tokens``)."""
    fg_idx: torch.Tensor      # (T,) int32 anchor slots, by priority
    bg_idx: torch.Tensor      # (T,) int32
    fg_valid: torch.Tensor    # (T,) bool: rank < min(n_fg, n_bg, T)
    bg_valid: torch.Tensor    # (T,) bool
    ok: torch.Tensor          # () bool: > 11 fg and > 11 bg candidates


def token_priorities(ts, n: int):
    """The uniform priorities of one phase-2 step's token draw, (fg, bg)
    each (n,), from the state's generator (JAX: ``uniform`` under the two
    halves of the step's key, step.py:147-156).  The one place the step
    draws random numbers: ``lax.top_k`` over JAX's draws cannot be
    reproduced from a torch.Generator, so the parity tests put JAX's draws
    here (they may read ``ts.step`` to find the step's key)."""
    dev = ts.scaffold.alive.device
    return (torch.rand(n, generator=ts.generator, device=dev),
            torch.rand(n, generator=ts.generator, device=dev))


def sample_cross_tokens(priorities, pos_x, pos_y, visible, alive, gt_mask,
                        box, width: int, height: int,
                        max_tokens: int) -> CrossTokens:
    """fg/bg anchor token sampling (train.py:436-513; JAX step.py:121).

    ``box`` = (min_y, max_y, min_x, max_x) of the sampled patch, a (4,)
    int tensor.  Anchors projecting inside the patch are split by the
    object mask into fg and bg candidates; the ``min(n_fg, n_bg,
    max_tokens)`` of each with the highest ``priorities`` are the valid
    tokens.  The slots past that count (``*_valid`` False) are the next
    by priority, and where candidates run out, entries at ``-inf`` in an
    order ``torch.topk`` and ``lax.top_k`` may break differently; no
    valid output depends on them (masked out of both softmaxes, never
    written back)."""
    xi = pos_x.to(torch.int32)
    yi = pos_y.to(torch.int32)
    valid2d = ((pos_x > 0) & (pos_x < width) & (pos_y > 0)
               & (pos_y < height) & visible & alive)
    xi = torch.clamp(xi, 0, width - 1)
    yi = torch.clamp(yi, 0, height - 1)
    min_y, max_y, min_x, max_x = box[0], box[1], box[2], box[3]
    in_box = ((yi >= min_y) & (yi < max_y) & (xi >= min_x) & (xi < max_x)
              & valid2d)
    fgbg = gt_mask[yi.long(), xi.long()] > 0.5
    fg_cand = in_box & fgbg
    bg_cand = in_box & ~fgbg
    n_fg = torch.sum(fg_cand.to(torch.int32))
    n_bg = torch.sum(bg_cand.to(torch.int32))
    min_num = torch.clamp_max(torch.minimum(n_fg, n_bg), max_tokens)
    ok = (n_fg > 11) & (n_bg > 11)   # the reference exits below 12 anchors
    rank = torch.arange(max_tokens, device=pos_x.device)

    def draw(u, cand):
        pri = torch.where(cand, u, -torch.inf)
        idx = torch.topk(pri, max_tokens).indices
        return idx.to(torch.int32), rank < min_num

    fg_idx, fg_valid = draw(priorities[0], fg_cand)
    bg_idx, bg_valid = draw(priorities[1], bg_cand)
    return CrossTokens(fg_idx, bg_idx, fg_valid, bg_valid, ok)


def crossattn_update(ca, feat, tok: CrossTokens, ema: float, is_ref: bool,
                     heads: int, dim_head: int):
    """run_crossattn (gaussian_model.py:553-583; JAX step.py:91).

    The anchor features are detached before attention; the attention
    outputs are EMA-mixed back at the valid sampled slots — the
    foreground side only on the reference view — and the result carries
    gradients to the cross-attention arrays ``ca`` only.  Nothing is
    written when ``tok.ok`` is False.  The writes go through one extra
    row, ``C``, that takes every dropped slot and is cut off after."""
    base = feat.detach()
    C = base.shape[0]
    fg_tok = base[tok.fg_idx.long()]
    bg_tok = base[tok.bg_idx.long()]
    fg_out, bg_out = bidirectional_attn(ca, fg_tok, bg_tok, heads, dim_head,
                                        mask=tok.fg_valid,
                                        context_mask=tok.bg_valid)
    drop = torch.full((), C, dtype=torch.int64, device=base.device)
    new_feat = torch.cat([base, base.new_zeros((1, base.shape[1]))])
    if is_ref:       # fg written only under the reference view (:576-579)
        fg_mix = ema * fg_out + (1 - ema) * fg_tok
        fg_dst = torch.where(tok.fg_valid & tok.ok, tok.fg_idx.long(), drop)
        new_feat = new_feat.index_copy(0, fg_dst, fg_mix)
    bg_mix = ema * bg_out + (1 - ema) * bg_tok
    bg_dst = torch.where(tok.bg_valid & tok.ok, tok.bg_idx.long(), drop)
    new_feat = new_feat.index_copy(0, bg_dst, bg_mix)
    return new_feat[:C]


def splat_view(params, mlps, scaffold: ScaffoldState, camera: Camera,
               screen_zero, cfg: ScaffoldConfig, capacity: int,
               precise_sort: bool = True):
    """Decode, preprocess and bin one view from explicit (differentiable)
    parameters; returns (Decoded, Splats, the projected means plus
    ``screen_zero``, Binning).  The binning goes through the emission
    selector ``build_binning`` (``GSCREAM_EMIT``; ``precise_sort=False``
    takes the quantized sort key) under ``torch.no_grad()`` (the JAX
    ``stop_gradient``, rasterize_tiled.py:1276-1277): gradients reach the
    gaussians only through the rasterizer's own arguments."""
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
        binning = build_binning(splats, dec.opacity, dec.color,
                                dec.uncertainty, capacity, w, h,
                                precise_sort)
    return dec, splats, mean2d, binning


def render_from_params(params, mlps, scaffold: ScaffoldState, camera: Camera,
                       bg, screen_zero, cfg: ScaffoldConfig, capacity: int,
                       precise_sort: bool = True):
    """Decode + rasterize from explicit (differentiable) parameters;
    returns (TiledOut, Decoded, Splats, Binning) (:func:`splat_view`)."""
    dec, splats, mean2d, binning = splat_view(
        params, mlps, scaffold, camera, screen_zero, cfg, capacity,
        precise_sort)
    with record_function("step/forward"):
        out = rasterize_tiled(mean2d, splats.conic, dec.opacity, dec.color,
                              splats.depth, dec.uncertainty, binning, bg,
                              camera.width, camera.height)
    return out, dec, splats, binning


def loss_terms(out, gt_image, gt_mask, midas_depth, fg_box_mask,
               opt: OptimConfig, is_ref: bool):
    """RGB + depth losses (train.py:535-573).  Images are (C,H,W).

    ``opt.loss_dtype == "bfloat16"`` runs the RGB L1/SSIM maps in
    bfloat16 with float32 means (step.py:171-173); the depth terms stay
    float32 (their scale/shift fit solves normal equations that cancel
    catastrophically in bfloat16)."""
    img = out.color.permute(2, 0, 1)
    if opt.loss_dtype == "bfloat16":
        img = img.to(torch.bfloat16)
        gt_image = gt_image.to(torch.bfloat16)
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


def phase2_masks(cross_ok):
    """Which groups the main Adam updates in phase 2 (step.py:292-307):
    a step whose token sampling degenerated (``cross_ok`` False) is
    skipped whole by the reference (train.py:519-523), so every group is
    masked on it; the anchor features belong to the cross-attention (the
    EMA write) and the cross-attention to its own Adam.  ``cross_ok`` is
    a bool or a () bool device tensor (JAX's traced mask)."""
    ok = cross_ok if isinstance(cross_ok, torch.Tensor) else bool(cross_ok)
    return {
        "params/anchor": ok, "params/offset": ok, "params/feat": False,
        "params/scaling": ok, "params/rotation": False,
        "params/opacity": False, "params/uncertainty": False,
        "mlps/opacity": ok, "mlps/uncertainty": ok, "mlps/cov": ok,
        "mlps/color": ok, "mlps/crossattn": False, "mlps/feat_bank": ok,
    }


@torch.no_grad()
def prefilter(scaffold: ScaffoldState, camera: Camera) -> Splats:
    """The anchors projected as gaussians of their own scale: their
    visibility (the densification statistics) and screen positions (the
    phase-2 token sampling) (step.py:234-245)."""
    p = scaffold.params
    with record_function("step/prefilter"):
        return preprocess(
            p.anchor, torch.exp(p.scaling[:, :3]),
            p.rotation / torch.clamp_min(torch.linalg.vector_norm(
                p.rotation, dim=1, keepdim=True), 1e-12),
            camera.w2c, camera.full_proj, camera.width, camera.height,
            camera.tan_fovx, camera.tan_fovy, tile_w=TILE_W, tile_h=TILE_H,
            active_mask=scaffold.alive)


def train_step(ts: TrainState, camera: Camera, gt_image, gt_mask,
               midas_depth, fg_box_mask, cross_box=None, *,
               cfg: ScaffoldConfig, opt: OptimConfig, is_ref: bool,
               use_crossattn: bool = False, capacity: int, width: int,
               height: int, accumulate: bool, white_bg: bool = False,
               spatial_lr_scale: float = 1.0, feat_frozen: bool = False,
               precise_sort: bool = True):
    """Launch one optimization iteration.  Returns (new_state, StepAux);
    the parameters and moments are updated in place, so ``ts`` itself
    holds the new values too — except where the step's device flag
    ``ok`` is False (an instance demand above ``capacity`` or a loss that
    is not finite): then no tensor of the state is written (module
    docstring).  Nothing is read to the host; ``aux_values(aux)`` reads
    the scalars.

    gt_image (3,H,W) · gt_mask (1,H,W) · midas_depth (1,H,W) ·
    fg_box_mask (H,W) random box for the ref-view fg depth term ·
    cross_box (4,) int32 patch for the phase-2 token sampling (zeros
    when None) · ``precise_sort=False`` bins with the quantized sort key
    (``bin_instances``).
    """
    if (camera.width, camera.height) != (width, height):
        raise ValueError(f"camera is {camera.width}x{camera.height}, the "
                         f"step was asked for {width}x{height}")
    scaffold = ts.scaffold
    dev = scaffold.alive.device
    C, k = cfg.capacity, cfg.n_offsets
    step1 = ts.step + 1
    p = scaffold.params

    pre = prefilter(scaffold, camera)
    anchor_visible = (pre.radius > 0) & scaffold.alive

    cross = None
    if use_crossattn:
        with record_function("step/tokens"), torch.no_grad():
            if cross_box is None:
                cross_box = torch.zeros(4, dtype=torch.int32, device=dev)
            n_tok = min(opt.crossattn_max_tokens, C)
            cross = sample_cross_tokens(
                token_priorities(ts, C), pre.mean2d[:, 0], pre.mean2d[:, 1],
                pre.radius > 0, scaffold.alive, gt_mask[0], cross_box,
                width, height, n_tok)
        grad_masks = dict(phase2_masks(True), **{"mlps/crossattn": True})
    else:
        grad_masks = phase1_masks(feat_frozen)
    g = loss_and_grads(scaffold, camera, gt_image, gt_mask, midas_depth,
                       fg_box_mask, cfg=cfg, opt=opt, is_ref=is_ref,
                       capacity=capacity, masks=grad_masks,
                       white_bg=white_bg, cross=cross,
                       precise_sort=precise_sort)

    with torch.no_grad():
        demand = overflow_demand(g.binning)
        cross_ok = (cross.ok if cross is not None else
                    torch.zeros((), dtype=torch.bool, device=dev))
        aux = pack_aux(g.loss.detach(), g.l1.detach(), demand,
                       torch.sum(g.dec.active.to(torch.int32)), cross_ok)
        # the write gate: a truncated instance list (the caller re-runs at
        # a larger capacity) or a garbage loss (the caller stops)
        ok = (demand <= capacity) & torch.isfinite(g.loss.detach())

    # --- densification stats (training_statis, train.py:599) ------------
    stats = ts.stats
    if accumulate:
        with torch.no_grad():
            # screen grads in the reference's NDC units (backward.cu:592)
            ndc = g.screen * device_constant((0.5 * width, 0.5 * height),
                                             dev)
            grad_norm = torch.linalg.vector_norm(ndc, dim=1).reshape(C, k)
            gauss_valid = (g.dec.active
                           & (g.splats.radius > 0)).reshape(C, k)
            stats = gate_stats(ok, accumulate_stats(
                stats, g.dec.neural_opacity.detach(), grad_norm,
                gauss_valid, anchor_visible), stats)

    # --- masked Adam, in place ------------------------------------------
    # a step with cross_ok False changes no parameter and no moment (and
    # still advances ``step``), as JAX's ``where`` masks gate it
    upd = ok & cross_ok
    lrs = lr_tree(step1, opt, spatial_lr_scale)
    params = named_params(scaffold)
    step_c1 = ts.step_c
    with record_function("step/adam"):
        if use_crossattn:
            apply_adam(params, g.grads, ts.m, ts.v, lrs, step1,
                       phase2_masks(upd))
            # JAX's masked Adam returns a masked leaf's passed-in value,
            # and the value it is passed for params/feat is
            # stop_gradient(feat_used) (step.py:317-318): the EMA-mixed
            # features are written back into the state.  The in-place
            # Adam skips masked groups, so the write is made here.
            with torch.no_grad():
                torch.where(ok, g.feat, p.feat, out=p.feat)
            # the cross-attention's own Adam (optimizer_c,
            # train.py:614-616): its own step count, run only on steps
            # where the attention ran, at the main step's learning rate
            step_c1 = ts.step_c + upd.to(torch.int32)
            ca = {n: t for n, t in params.items()
                  if group_of(n) == "mlps/crossattn"}
            apply_adam(ca, g.grads, ts.m, ts.v, lrs,
                       device_bias(torch.clamp_min(step_c1, 1), step1),
                       {"mlps/crossattn": upd})
        else:
            apply_adam(params, g.grads, ts.m, ts.v, lrs, step1,
                       phase1_masks(feat_frozen), ok)
    return ts._replace(step=step1, step_c=step_c1, stats=stats), aux


def gate_stats(ok: torch.Tensor, new, old):
    """``new`` densification statistics where the device flag ``ok`` is
    True, ``old`` where it is False."""
    return type(old)(*(torch.where(ok, a, b) for a, b in zip(new, old)))


class StepGrads(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    grads: Dict[str, torch.Tensor]  # named_params key → gradient, for
                                    # the groups the masks update
    screen: torch.Tensor     # (C·k, 2) gradient of the projected means
    dec: Decoded
    splats: Splats
    binning: Binning
    feat: Optional[torch.Tensor] = None  # phase 2: the features rendered
                                         # (EMA-mixed), detached


def loss_and_grads(scaffold: ScaffoldState, camera: Camera, gt_image,
                   gt_mask, midas_depth, fg_box_mask, *, cfg: ScaffoldConfig,
                   opt: OptimConfig, is_ref: bool, capacity: int, masks,
                   white_bg: bool = False,
                   cross: Optional[CrossTokens] = None,
                   render_loss=None, seed=None,
                   precise_sort: bool = True) -> StepGrads:
    """The loss of one view and its gradients with respect to the
    parameters of every group that ``masks`` updates and to the projected
    means (``value_and_grad`` of ``loss_fn``, step.py:255-274).  With
    ``cross`` (phase 2) the features are first EMA-mixed by the
    cross-attention, whose arrays enter autograd as leaves of their own,
    as the anchor tensors do.

    ``render_loss(params, mlps, screen_zero, bg) -> (loss, l1, Decoded,
    Splats, Binning)`` takes the place of the render and
    :func:`loss_terms` (the band path of ``parallel/shard.py``), and
    ``seed`` is the cotangent the loss is differentiated with (1 by
    default)."""
    dev = scaffold.alive.device
    bg = (torch.ones(3, device=dev) if white_bg
          else torch.zeros(3, device=dev))
    p = scaffold.params
    anchor = type(p)(*(t.detach().requires_grad_() for t in p))
    ca, feat_used, render_params = {}, None, anchor
    if cross is not None:
        ca = {name: t.detach().requires_grad_()
              for name, t in scaffold.mlps.crossattn.arrays()}
        with record_function("step/crossattn"):
            feat_used = crossattn_update(
                ca, anchor.feat, cross, opt.crossattn_feat_update_ema,
                is_ref, cfg.attn_heads, cfg.attn_head_dim)
        render_params = anchor._replace(feat=feat_used)
    screen_zero = torch.zeros((cfg.capacity * cfg.n_offsets, 2),
                              device=dev, requires_grad=True)
    if render_loss is None:
        out, dec, splats, binning = render_from_params(
            render_params, scaffold.mlps, scaffold, camera, bg, screen_zero,
            cfg, capacity, precise_sort)
        with record_function("step/losses"):
            loss, l1 = loss_terms(out, gt_image, gt_mask, midas_depth,
                                  fg_box_mask, opt, is_ref)
    else:
        loss, l1, dec, splats, binning = render_loss(
            render_params, scaffold.mlps, screen_zero, bg)
    # the autograd leaves: the fresh anchor and cross-attention tensors
    # and the MLP weights
    leaves = {}
    for name, t in named_params(scaffold).items():
        if not masks[group_of(name)]:
            continue
        if name.startswith("params/"):
            t = getattr(anchor, name[len("params/"):])
        elif name.startswith("mlps/crossattn/"):
            t = ca[name[len("mlps/crossattn/"):]]
        leaves[name] = t
    with record_function("step/backward"):
        grads = torch.autograd.grad(
            loss, list(leaves.values()) + [screen_zero], grad_outputs=seed,
            allow_unused=True)
    return StepGrads(
        loss=loss, l1=l1, screen=grads[-1], dec=dec, splats=splats,
        binning=binning,
        grads={name: torch.zeros_like(t) if g is None else g
               for (name, t), g in zip(leaves.items(), grads[:-1])},
        feat=None if feat_used is None else feat_used.detach())
