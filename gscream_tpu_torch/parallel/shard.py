"""Sharded rendering and training over a (data, tiles) mesh (counterpart
of ``gscream_tpu/parallel/shard.py``).

* The image's tile grid is cut into contiguous **bands of tile rows**,
  one per rank of a tile group; each rank runs K1 and K2 on its band's
  tiles only (the per-tile instance lists are already independent).
  Every rank bins its whole view (K5/K6, or K9a/K9b/K8 under
  ``GSCREAM_EMIT=pallas``) and slices its band's tile ranges.  Where the
  tile rows do not divide by the band count, pad tiles extend the grid.
* Rendered images stay band-local: the losses are taken by
  :mod:`.band_loss` with an 8-row halo exchange and ~20 summed scalars.
* Per-gaussian gradients come from the band's K2 rows through the same
  ``GSCREAM_REORDER`` selector as one device (K4+K3 under ``cm``, K7
  otherwise): K2 zeroes every slot outside the band's ranges, so each
  band's sums are its partials, added over the mesh.
* Views are sharded along ``data``; the step's loss is the gated mean
  over the views.  The step is ``train_step``'s, with its span, token
  draw and update (``train.step``'s module docstring).

Every rank holds the whole replicated :class:`~..train.state.TrainState`
and applies the same masked Adam to the same reduced gradients: the sums
are gathers added in rank order (:mod:`.distributed`), so the replicas
stay bit-equal (:func:`check_replicas`).  Where the JAX package's
``shard_map`` transpose inserts the gradient ``psum`` for replicated
inputs, this port differentiates each view's band-reduced loss, which
its ``T`` band ranks hold alike, once: the band-0 rank seeds it with the
view's weight in the gated mean and the others with zero; the adjoints of
the in-loss sums hand every band its share, and the parameters'
gradients are then summed over the mesh.
"""
from __future__ import annotations

import hashlib
from typing import List, NamedTuple

import torch
from torch.profiler import record_function

from ..cameras import Camera
from ..config import OptimConfig
from ..model.scaffold import ScaffoldConfig, ScaffoldState
from ..ops import rasterize_tiled as rt
from ..ops.binning import Binning, overflow_demand
from ..ops.rasterize_tiled import TILE_H, TILE_W, TiledOut
from ..train.state import TrainState, anchor_rows, named_params
from ..train.step import (grad_masks, loss_and_grads, pack_aux, phase1_masks,
                          phase2_tokens, prefilter, screen_grad_norm,
                          splat_view, update_state)
from .band_loss import band_loss_terms
from .distributed import all_gather, ordered_sum, pmax, pmean, sum_over
from .mesh import Mesh


def _band_geometry(width: int, height: int, n_bands: int):
    """(tiles per row, tile rows, tile rows padded to the bands, tile rows
    per band)."""
    gx = -(-width // TILE_W)
    gy = -(-height // TILE_H)
    gy_pad = -(-gy // n_bands) * n_bands
    return gx, gy, gy_pad, gy_pad // n_bands


def _band_slices(binning: Binning, gx: int, rows_per_band: int, band: int):
    """The band's (tile_start, tile_count) slices and its tile count."""
    n_local = rows_per_band * gx
    first = band * n_local
    return (binning.tile_start[first:first + n_local],
            binning.tile_count[first:first + n_local], n_local)


def pad_tiles(binning: Binning, width: int, height: int,
              n_bands: int) -> Binning:
    """The tile-range arrays extended to the banded grid (:213-232).  Pad
    tiles carry start = the last real tile's end and count 0, never start
    0: a pad tile ends its band's grid, and K2 zero-fills the slots past
    the last tile's end and before the first tile's start, so a 0-start
    pad tile would wipe the gradient rows its band had just written."""
    gx, gy, gy_pad, _ = _band_geometry(width, height, n_bands)
    n_pad = (gy_pad - gy) * gx
    if not n_pad:
        return binning
    end = binning.tile_start[-1:] + binning.tile_count[-1:]
    return binning._replace(
        tile_start=torch.cat([binning.tile_start, end.expand(n_pad)]),
        tile_count=torch.cat([binning.tile_count,
                              binning.tile_count.new_zeros(n_pad)]))


def _band_rows(x: torch.Tensor, band: int, bh: int,
               height: int) -> torch.Tensor:
    """``x`` (…, bh, W) with the rows past ``height`` zeroed."""
    grow = band * bh + torch.arange(bh, device=x.device)
    return torch.where((grow < height)[:, None], x, torch.zeros_like(x))


class _RasterizeBand(torch.autograd.Function):
    """``_band_fwd_at`` / ``_band_bwd_at`` (shard.py:82-187)."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, colors, depth, unc, bg,
                binning: Binning, width: int, height: int, n_bands: int,
                band: int):
        gx, _, _, rows = _band_geometry(width, height, n_bands)
        bh = rows * TILE_H
        # legacy records carry tile-local coefficients packed from each
        # instance's global tile id, so K1 needs no tile offset; raw K1
        # finds its tiles' origins from the band's first global tile
        # (shard.py:90-99)
        raw = rt.kernel_coeff()
        inst = rt.pack_instance_data(mean2d, conic, opacity, colors,
                                     depth, unc, binning, gx, raw)
        ts, tc, n_local = _band_slices(binning, gx, rows, band)
        tiles = rt.tile_forward(inst, ts, tc, n_local, raw, gx,
                                band * n_local)              # (L, 8, PIX)
        img = tiles.reshape(rows, gx, 8, TILE_H, TILE_W).permute(
            2, 0, 3, 1, 4).reshape(8, bh, gx * TILE_W)[:, :, :width]
        # K1 renders the last band's rows past ``height``; they are zeroed,
        # so the losses' zero-padded windows and the halo exchange see
        # what a full-frame crop would
        img = _band_rows(img, band, bh, height)
        raw_c, d_img, u_img, t_img = img[1:4], img[4], img[5], img[6]
        color = raw_c + t_img[None] * bg[:, None, None]
        ctx.save_for_backward(inst, bg, raw_c, d_img, u_img, t_img, mean2d,
                              conic, opacity)
        ctx.binning = binning
        ctx.geom = (width, height, n_bands, band)
        ctx.raw = raw
        return color.permute(1, 2, 0), d_img, u_img, t_img

    @staticmethod
    def backward(ctx, g_color, g_depth, g_unc, g_tfin):
        (inst, bg, raw_c, d_img, u_img, t_img, mean2d, conic,
         op) = ctx.saved_tensors
        width, height, n_bands, band = ctx.geom
        gx, _, _, rows = _band_geometry(width, height, n_bands)
        bh = rows * TILE_H
        # the transpose of the forward's zeroing of the rows past height
        gc = _band_rows(g_color.permute(2, 0, 1), band, bh, height)
        g_depth = _band_rows(g_depth, band, bh, height)
        g_unc = _band_rows(g_unc, band, bh, height)
        g_tfin = _band_rows(g_tfin, band, bh, height)
        ts, tc, n_local = _band_slices(ctx.binning, gx, rows, band)
        with record_function("raster_bwd/K2 tile_backward"):
            pix = rt.pixel_rows(raw_c, d_img, u_img, t_img, bg, gc,
                                g_depth, g_unc, g_tfin, width, bh)
            grad_rows = rt.tile_backward(inst, pix, ts, tc, n_local,
                                         ctx.raw, gx, band * n_local)
        # K2 zeroed the slots outside the band: the sums are its partials
        pg = rt.segment_sums(grad_rows, ctx.binning)
        with record_function("raster_bwd/chain"):
            grads = rt.pergauss_chain(pg, mean2d, conic, op)
            d_bg = (t_img[None] * gc).sum(dim=(1, 2))
        return grads + (d_bg, None, None, None, None, None)


def rasterize_band(mean2d, conic, opacity, colors, depth, unc,
                   binning: Binning, bg, width: int, height: int,
                   n_bands: int, band: int) -> TiledOut:
    """Rasterize band ``band`` of ``n_bands`` (tile rows ``band ·
    rows_per_band`` on, of a binning padded by :func:`pad_tiles`): a
    band-local ``TiledOut`` of ``rows_per_band · 32`` rows (the last
    band's rows past ``height`` are zero), differentiable as
    :func:`~..ops.rasterize_tiled.rasterize_tiled` is; its gradients are
    this band's partials."""
    return TiledOut(*_RasterizeBand.apply(
        mean2d, conic, opacity, colors, depth, unc, bg, binning, width,
        height, n_bands, band))


def render_view_sharded(scaffold: ScaffoldState, camera: Camera, bg,
                        cfg: ScaffoldConfig, capacity: int, n_bands: int,
                        band: int, screen_zero=None):
    """decode → preprocess → bin the whole view → rasterize the band;
    returns (TiledOut of the band, Decoded, Splats, Binning).
    ``screen_zero`` is the densification's screen-gradient probe, as in
    :func:`~..train.step.render_from_params` (zeros for the rows given)."""
    if screen_zero is None:
        screen_zero = scaffold.params.anchor.new_zeros(
            (scaffold.alive.shape[0] * cfg.n_offsets, 2))
    dec, splats, mean2d, binning = splat_view(
        scaffold.params, scaffold.mlps, scaffold, camera, screen_zero, cfg,
        capacity)
    binning = pad_tiles(binning, camera.width, camera.height, n_bands)
    with record_function("step/forward"):
        out = rasterize_band(mean2d, splats.conic, dec.opacity, dec.color,
                             splats.depth, dec.uncertainty, binning, bg,
                             camera.width, camera.height, n_bands, band)
    return out, dec, splats, binning


class ViewBatch(NamedTuple):
    """The B views of one sharded step, held whole by every rank: rank
    ``(d, band)`` takes view ``d``."""
    cameras: List[Camera]
    image: torch.Tensor        # (B, 3, H, W)
    mask: torch.Tensor         # (B, 1, H, W)
    depth: torch.Tensor        # (B, 1, H, W) mono depth
    is_ref: List[bool]
    fg_box: torch.Tensor       # (B, H, W) the ref view's fg depth box
    cross_box: torch.Tensor    # (B, 4) int32 phase-2 patch
    cross_enable: List[bool]   # phase 2 runs on the view


def sharded_view_batch(views, fg_boxes=None, is_ref=None, cross_boxes=None,
                       cross_enable=None, device=None) -> ViewBatch:
    """Stack per-view data into a :class:`ViewBatch` (shard.py:287).
    ``views`` carry ``camera``, ``image``, ``mask`` and ``depth`` as
    attributes or dict keys; the rest default to phase 1 (no reference
    view, no fg box, no cross-attention)."""
    def fld(v, name):
        return v[name] if isinstance(v, dict) else getattr(v, name)

    cams = [fld(v, "camera") for v in views]
    dev = torch.device(device) if device is not None else cams[0].w2c.device
    b, h, w = len(views), cams[0].height, cams[0].width

    def stack(xs, dtype=torch.float32):
        return torch.stack([torch.as_tensor(x, dtype=dtype, device=dev)
                            for x in xs])
    return ViewBatch(
        cameras=cams,
        image=stack([fld(v, "image") for v in views]),
        mask=stack([fld(v, "mask") for v in views]),
        depth=stack([fld(v, "depth") for v in views]),
        is_ref=[bool(x) for x in (is_ref if is_ref is not None
                                  else [False] * b)],
        fg_box=(stack(fg_boxes) if fg_boxes is not None
                else torch.zeros((b, h, w), device=dev)),
        cross_box=(stack(cross_boxes, torch.int32)
                   if cross_boxes is not None
                   else torch.zeros((b, 4), dtype=torch.int32, device=dev)),
        cross_enable=[bool(x) for x in (cross_enable if cross_enable
                                        is not None else [False] * b)])


def _rank_grads(mesh: Mesh, cfg, opt, capacity, width, height, sc, batch,
                masks, seed, cross=None, white_bg=False):
    """This rank's view loss (band-reduced) and its partial gradients:
    ``loss_and_grads`` with the band render and the band losses."""
    d, band, n = mesh.data_index, mesh.band, mesh.tiles
    cam = batch.cameras[d]
    if (cam.width, cam.height) != (width, height):
        raise ValueError(f"camera is {cam.width}x{cam.height}, the step "
                         f"was asked for {width}x{height}")
    rows = _band_geometry(width, height, n)[3]

    def render_loss(params, mlps, screen_zero, bg):
        out, dec, splats, binning = render_view_sharded(
            sc._replace(params=params, mlps=mlps), cam, bg, cfg, capacity,
            n, band, screen_zero)
        with record_function("step/losses"):
            loss, l1 = band_loss_terms(
                out, band * rows * TILE_H, batch.image[d], batch.mask[d],
                batch.depth[d], batch.fg_box[d], opt, batch.is_ref[d],
                height, width, mesh.tile_group, n, band)
        return loss, l1, dec, splats, binning

    return loss_and_grads(
        sc, cam, None, None, None, None, cfg=cfg, opt=opt,
        is_ref=batch.is_ref[d], capacity=capacity, masks=masks,
        white_bg=white_bg, cross=cross, render_loss=render_loss, seed=seed)


def _mesh_sum(grads, screen, mesh: Mesh):
    """Partial gradients → the mesh's sums: the screen gradient over the
    tile group (a view's own), the parameters' over the whole mesh; one
    gather per axis, added in rank order."""
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1) for n in names]
                     + [screen.reshape(-1)])
    flat = sum_over(flat, mesh.tile_group)
    n_screen = screen.numel()
    params = sum_over(flat[:-n_screen], mesh.data_group)
    out, at = {}, 0
    for name in names:
        size = grads[name].numel()
        out[name] = params[at:at + size].reshape(grads[name].shape)
        at += size
    return out, flat[-n_screen:].reshape(screen.shape)


def _seed(mesh: Mesh, weight: torch.Tensor) -> torch.Tensor:
    """The cotangent this rank differentiates its view's loss with: the
    view's weight on its band-0 rank, zero on the others."""
    return weight if mesh.band == 0 else torch.zeros_like(weight)


def make_sharded_loss(mesh: Mesh, cfg: ScaffoldConfig, opt: OptimConfig,
                      capacity: int, width: int, height: int):
    """``loss_fn(scaffold, batch) -> (loss, grads)`` (shard.py:239): the
    mean over the mesh's views of each view's phase-1 loss and its
    gradients with respect to every parameter outside the
    cross-attention (``named_params`` keys), summed over the mesh; the
    same on every rank.  The render and loss core the parity tests
    compare; :func:`make_sharded_train_step` carries the whole step."""
    every = {g: g != "mlps/crossattn" for g in phase1_masks(False)}

    def loss_fn(scaffold: ScaffoldState, batch: ViewBatch):
        dev = scaffold.alive.device
        w = torch.tensor(1.0 / mesh.data, device=dev)
        g = _rank_grads(mesh, cfg, opt, capacity, width, height, scaffold,
                        batch, every, _seed(mesh, w))
        grads, _ = _mesh_sum(g.grads, g.screen, mesh)
        return pmean(g.loss.detach(), mesh.data_group), grads

    return loss_fn


def make_sharded_train_step(mesh: Mesh, cfg: ScaffoldConfig,
                            opt: OptimConfig, capacity: int, width: int,
                            height: int, *, white_bg: bool = False,
                            spatial_lr_scale: float = 1.0):
    """The training step over a (data, tiles) mesh (shard.py:318):
    ``step(ts, batch, use_crossattn=False, feat_frozen=False,
    accumulate=False) -> (TrainState, StepAux)``,
    :func:`~..train.step.train_step` over the ``B = mesh.data`` views of
    ``batch``, all from the same pre-step state, over the same anchor
    span and through the same update (``train.step.update_state``):

    * each view's ``is_ref`` loss and the reference view's fg-box term;
    * phase 2: each view's tokens drawn in view order (view j the j-th
      draw, so B = 1 draws what ``train_step`` draws); a view with
      cross-attention on whose sampling failed is dropped (the
      reference's ``except: continue``); the gate ``g`` is 1 for the
      others;
    * the loss differentiated is the gated mean Σ g·loss / max(Σ g, 1);
      the reported loss and l1 are the plain means;
    * densification statistics from each view's own screen gradient
      (rescaled by Σ g), gated, added view by view in order;
    * the EMA feature writes: each view's deltas summed over the views
      (for B = 1 the view's features).

    The overflow demand is the max over every rank and the step's
    scalars are gathered before anything is written, so every rank's
    write gate ``ok`` is the same device flag, read by no rank: above
    ``capacity`` (or a loss that is not finite) no rank writes, and the
    caller re-runs the step on every rank.  For B = 1 and any band count
    the step is ``train_step``'s up to float32 reassociation."""
    B = mesh.data
    C, k = cfg.capacity, cfg.n_offsets

    def step(ts: TrainState, batch: ViewBatch, use_crossattn: bool = False,
             feat_frozen: bool = False, accumulate: bool = False):
        if len(batch.cameras) != B:
            raise ValueError(f"a batch of {len(batch.cameras)} views for a "
                             f"mesh of {B} data rows")
        whole, S = ts, ts.span
        if S < C:
            ts = anchor_rows(ts, S)
        sc = ts.scaffold
        dev = sc.alive.device
        d = mesh.data_index
        pres = ([prefilter(sc, cam) for cam in batch.cameras]
                if accumulate or use_crossattn else None)
        cross = None
        gate = torch.ones(B, device=dev)
        if use_crossattn:
            toks = [phase2_tokens(ts, pre, batch.mask[j][0],
                                  batch.cross_box[j], width, height,
                                  opt.crossattn_max_tokens, C)
                    for j, pre in enumerate(pres)]
            act = torch.tensor(batch.cross_enable).to(dev, non_blocking=True)
            ok_act = torch.stack([t.ok for t in toks]) & act
            gate = torch.where(act, ok_act.to(torch.float32), 1.0)
            cross = toks[d]._replace(ok=ok_act[d])
        gsum = torch.clamp_min(gate.sum(), 1.0)
        g = _rank_grads(mesh, cfg, opt, capacity, width, height, sc, batch,
                        grad_masks(use_crossattn, feat_frozen),
                        _seed(mesh, gate[d] / gsum), cross, white_bg)

        with torch.no_grad():
            demand = pmax(overflow_demand(g.binning), mesh.world_group)
            views = all_gather(torch.stack([
                g.loss.detach(), g.l1.detach(),
                g.dec.active.sum().to(torch.float32)]), mesh.data_group)
            any_cross = (ok_act.any() if use_crossattn else
                         torch.zeros((), dtype=torch.bool, device=dev))
            loss = ordered_sum([v[0] for v in views]) / B
            aux = pack_aux(loss, ordered_sum([v[1] for v in views]) / B,
                           demand, views[0][2], any_cross)
            # the write gate, the same on every rank (gathered scalars)
            ok = (demand <= capacity) & torch.isfinite(loss)
            grads, screen = _mesh_sum(g.grads, g.screen, mesh)
            stat_views = None
            if accumulate:
                valid = (g.dec.active & (g.splats.radius > 0)).reshape(S, k)
                parts = all_gather(torch.stack([
                    g.dec.neural_opacity.detach(),
                    screen_grad_norm(screen, width, height, k) * gsum,
                    valid.to(torch.float32)]), mesh.data_group)
                stat_views = []
                for v, (nop, gn, gv) in enumerate(parts):
                    on = gate[v] > 0
                    stat_views.append((nop, gn, (gv > 0) & on,
                                       (pres[v].radius > 0) & sc.alive & on))
            feat = None
            if use_crossattn:     # each view's EMA deltas, summed
                feats = all_gather(g.feat, mesh.data_group)
                p = sc.params
                feat = feats[0] if B == 1 else p.feat + ordered_sum(
                    [f - p.feat for f in feats])
        # a step gated off in every view changes no main group
        upd_ok = ok if not all(batch.cross_enable) else ok & any_cross
        return update_state(whole, ts, grads, ok, upd_ok, ok & any_cross,
                            stat_views, feat, opt=opt,
                            use_crossattn=use_crossattn,
                            feat_frozen=feat_frozen,
                            spatial_lr_scale=spatial_lr_scale), aux

    return step


def state_digest(ts: TrainState) -> str:
    """SHA-256 of the whole state: every parameter, moment and statistic,
    ``alive``, ``xyz_max``, the step counts and the generator."""
    h = hashlib.sha256()

    def add(t):
        h.update(t.detach().cpu().reshape(-1).contiguous().view(
            torch.uint8).numpy().tobytes())
    for name, t in named_params(ts.scaffold).items():
        h.update(name.encode())
        add(t)
        add(ts.m[name])
        add(ts.v[name])
    for t in ts.stats:
        add(torch.as_tensor(t))
    add(ts.scaffold.alive.to(torch.uint8))
    add(ts.scaffold.xyz_max)
    h.update(f"{ts.step} {int(ts.step_c)}".encode())
    add(ts.generator.get_state())
    return h.hexdigest()


def check_replicas(ts: TrainState, mesh: Mesh) -> str:
    """The state's digest, after checking that every rank's is the same
    (a gather over the mesh); raises on the first rank that differs."""
    digest = state_digest(ts)
    mine = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.uint8)
    if mesh.world_group is not None and ts.scaffold.alive.is_cuda and \
            torch.distributed.get_backend(mesh.world_group) == "nccl":
        mine = mine.to(ts.scaffold.alive.device)
    got = [bytes(t.cpu().tolist()).hex()
           for t in all_gather(mine, mesh.world_group)]
    bad = [r for r, x in enumerate(got) if x != digest]
    if bad:
        raise RuntimeError(f"replicas differ: ranks {bad} hold another "
                           f"state than rank {mesh.rank}")
    return digest
