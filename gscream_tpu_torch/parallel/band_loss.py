"""Band-local GScream losses with a halo exchange (counterpart of
``gscream_tpu/parallel/band_loss.py``).

Every loss of a training step (train.py:535-573) is local up to a small
row halo and a handful of global sums:

* the masked L1 terms are sums over pixels;
* the training SSIM (11×11 window, zero padding) reads ±5 rows;
* the MiDaS scale/shift fit needs five sums (its 2×2 normal equations);
* the multiscale gradient pyramid at strides 1, 2, 4, 8 reads up to 8
  rows ahead.

So each band rank exchanges :data:`HALO` = 8 rendered rows with each
neighbour of its tile group and sums ~20 scalars over the group, in two
:func:`~.distributed.psum` calls.  Band heights are multiples of
``TILE_H`` = 32, so every pyramid stride divides the band origin and the
strided grids partition exactly across bands.

For any band count the total loss, and its gradients through the
differentiable halo exchange and sums, equals
:func:`~..train.step.loss_terms` up to float32 reassociation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import OptimConfig
from ..ops.losses import _abs
from ..ops.ssim import _ssim_map
from .distributed import neighbour_exchange, psum

HALO = 8          # rows exchanged each way (the SSIM needs 5, the stride-8
                  # pyramid 8)


def halo_exchange(band: torch.Tensor, group, n_bands: int,
                  index: int) -> torch.Tensor:
    """(C, bh, W) → (C, HALO + bh + HALO, W) with the neighbours' edge
    rows; the first band's top halo and the last band's bottom halo stay
    zero, the global zero padding of the training SSIM at the image
    border."""
    if n_bands == 1:
        z = band.new_zeros(band.shape[:-2] + (HALO, band.shape[-1]))
        return torch.cat([z, band, z], dim=-2)
    return neighbour_exchange(band, group, n_bands, index, HALO)


def _own(x_ext: torch.Tensor, bh: int) -> torch.Tensor:
    """The owned rows of a halo-extended strip."""
    return x_ext[..., HALO:HALO + bh, :]


def _row_weight(row0: int, bh: int, height: int, device) -> torch.Tensor:
    """(bh, 1): 1 for rows inside the image, 0 for the last band's
    padding rows."""
    r = row0 + torch.arange(bh, device=device)
    return (r < height)[:, None].to(torch.float32)


def _grad_pyramid_partials(aligned_ext, target_ext, mask_ext, row0: int,
                           bh: int, height: int, levels: int = 4):
    """This band's partials of the multiscale gradient loss
    (train.py:224-249): per level, Σ|∂(masked diff)| over the differences
    it owns and Σ mask over its strided rows; ``gradient_loss`` divides
    per level after the sums.  A vertical difference (r, r + step) belongs
    to the band owning row r, a horizontal one to the band owning its row;
    row0 is a multiple of 32, so the global strided grid inside the band
    is ``ext[HALO + (0, step, …), :]``."""
    nums, dens = [], []
    dev = aligned_ext.device
    for s in range(levels):
        step = 2 ** s
        n_rows = bh // step
        rows = HALO + torch.arange(n_rows + 1, device=dev) * step
        a = aligned_ext[rows, ::step]
        t = target_ext[rows, ::step]
        m = mask_ext[rows, ::step]
        diff = (a - t) * m
        rw = ((row0 + torch.arange(n_rows + 1, device=dev) * step)
              < height).to(torch.float32)[:, None]
        own_w = rw[:n_rows]
        gx = _abs(diff[:n_rows, 1:] - diff[:n_rows, :-1]) \
            * (m[:n_rows, 1:] * m[:n_rows, :-1]) * own_w
        gy = _abs(diff[1:] - diff[:-1]) * (m[1:] * m[:-1]) * own_w * rw[1:]
        nums.append(torch.sum(gx) + torch.sum(gy))
        dens.append(torch.sum(m[:n_rows] * own_w))
    return torch.stack(nums), torch.stack(dens)


def band_loss_terms(out_band, row0: int, gt_image, gt_mask, midas_depth,
                    fg_box_mask, opt: OptimConfig, is_ref: bool, height: int,
                    width: int, group, n_bands: int, band: int):
    """The band-sharded ``train.step.loss_terms``.

    ``out_band``: a ``TiledOut`` of this band's (bh, W) rows; ``row0``:
    its first global row; ``gt_image`` (3,H,W), ``gt_mask`` (1,H,W),
    ``midas_depth`` (1,H,W) and ``fg_box_mask`` (H,W) are the whole
    frame's training data, which every rank holds (only rendered rows
    travel between bands).  ``group`` holds the ``n_bands`` ranks of the
    view in band order, this one at ``band``.  Both branches' partial sums
    are taken, as in the JAX package, and ``is_ref`` picks one.  Returns
    (loss, l1), the same on every band rank of the view."""
    if opt.loss_dtype != "float32":
        raise NotImplementedError(
            f"loss_dtype={opt.loss_dtype!r}: only the float32 loss path "
            "is ported")
    dev = out_band.depth.device
    bh = out_band.depth.shape[0]
    img_band = out_band.color.permute(2, 0, 1)         # (3, bh, W)
    dep_band = out_band.depth                          # (bh, W)
    below = bh * n_bands - height                      # padding rows

    def band_rows(full):
        return F.pad(full, (0, 0, 0, below))[..., row0:row0 + bh, :]

    def ext_rows(full):
        """Halo-extended strip of a full-frame tensor."""
        return F.pad(full, (0, 0, HALO, HALO + below))[
            ..., row0:row0 + bh + 2 * HALO, :]

    rw = _row_weight(row0, bh, height, dev)            # (bh, 1)
    npix = float(height * width)

    gt_band = band_rows(gt_image)
    mask_band = band_rows(gt_mask)
    mono_band = band_rows(midas_depth[0])
    fgbox_band = band_rows(fg_box_mask)

    img_ext = halo_exchange(img_band, group, n_bands, band)
    gt_ext = ext_rows(gt_image)

    # the SSIM map over the band's real rows, built once for all three
    # weighted sums
    m_own = _own(_ssim_map(img_ext, gt_ext), bh) * rw[None]
    l1_map = _abs(img_band - gt_band) * rw[None]
    w_band = (1.0 - mask_band) + opt.other_rgb_lr_fg * mask_band
    sums = [torch.sum(l1_map), torch.sum(m_own),              # ref plain
            torch.sum(l1_map * mask_band), torch.sum(m_own * mask_band),
            torch.sum(l1_map * w_band), torch.sum(m_own * w_band)]  # other
    valid_band = (1.0 - mask_band[0]) * rw

    # MiDaS scale/shift normal equations on the valid region
    p, t_, mk = dep_band, mono_band, valid_band
    ss = [torch.sum(mk * p * p), torch.sum(mk * p), torch.sum(mk),
          torch.sum(mk * p * t_), torch.sum(mk * t_)]
    red1 = psum(torch.stack(sums + ss), group)
    a00, a01, a11, b0, b1 = red1[6], red1[7], red1[8], red1[9], red1[10]
    det = a00 * a11 - a01 * a01
    ok = det != 0.0
    zero = torch.zeros_like(det)
    safe = torch.where(ok, det, torch.ones_like(det))
    s_fit = _abs(torch.where(ok, (a11 * b0 - a01 * b1) / safe, zero))
    t_fit = torch.where(ok, (-a01 * b0 + a00 * b1) / safe, zero)

    aligned_band = s_fit * dep_band + t_fit
    aligned_ext = halo_exchange(aligned_band[None], group, n_bands,
                                band)[0]
    mono_ext = ext_rows(midas_depth[0])

    # depth partial sums of both branches
    dl1_map = _abs(aligned_band - mono_band)
    dsum = [torch.sum(dl1_map * rw),                   # ref: full image
            torch.sum(dl1_map * fgbox_band * rw),      # ref: fg box
            torch.sum(dl1_map * valid_band)]           # other: background
    # pyramid masks: ref = ones, other = background; both zero beyond the
    # real image, so the halo rows past it vanish
    ridx = row0 - HALO + torch.arange(bh + 2 * HALO, device=dev)
    real = ((ridx >= 0) & (ridx < height)).to(torch.float32)[:, None]
    ones_ext = real.expand(bh + 2 * HALO, width)
    bg_ext = ext_rows(1.0 - gt_mask[0]) * real
    nums_1, dens_1 = _grad_pyramid_partials(aligned_ext, mono_ext, ones_ext,
                                            row0, bh, height)
    nums_m, dens_m = _grad_pyramid_partials(aligned_ext, mono_ext, bg_ext,
                                            row0, bh, height)
    red2 = psum(torch.cat([torch.stack(dsum), nums_1, dens_1, nums_m,
                           dens_m]), group)
    dsum_g = red2[:3]

    def pyr_of(nums_g, dens_g):
        return torch.sum(torch.where(
            dens_g > 0, nums_g / torch.clamp_min(dens_g, 1.0),
            torch.zeros_like(nums_g)))

    if is_ref:
        l1 = red1[0] / (3.0 * npix)
        ssim_ref = red1[1] / (3.0 * npix)
        loss = opt.refer_rgb_lr * ((1 - opt.lambda_dssim) * l1
                                   + opt.lambda_dssim * (1 - ssim_ref))
        if opt.refer_rgb_lr_fg > opt.refer_rgb_lr:
            l1m = red1[2] / (3.0 * npix)
            ssim_m = red1[3] / (3.0 * npix)
            loss = loss + (opt.refer_rgb_lr_fg - opt.refer_rgb_lr) * (
                (1 - opt.lambda_dssim) * l1m
                + opt.lambda_dssim * (1 - ssim_m))
        if opt.refer_depth_lr > 0:
            dloss = opt.refer_depth_lr * (dsum_g[0] / npix)
            if opt.refer_depth_lr_fg > opt.refer_depth_lr:
                dloss = dloss + (opt.refer_depth_lr_fg
                                 - opt.refer_depth_lr) * (dsum_g[1] / npix)
            dloss = dloss + 0.5 * opt.refer_depth_lr_smooth * pyr_of(
                red2[3:7], red2[7:11])
            loss = loss + dloss
    else:
        l1 = red1[4] / (3.0 * npix)
        ssim_o = red1[5] / (3.0 * npix)
        loss = opt.other_rgb_lr * ((1 - opt.lambda_dssim) * l1
                                   + opt.lambda_dssim * (1 - ssim_o))
        if opt.other_depth_lr > 0:
            loss = loss + opt.other_depth_lr * (dsum_g[2] / npix) \
                + 0.5 * opt.other_depth_lr_smooth * pyr_of(red2[11:15],
                                                           red2[15:19])
    return loss, l1
