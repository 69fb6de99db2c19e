"""Training losses: masked RGB, scale/shift-aligned depth, smoothness
(counterpart of ``gscream_tpu/ops/losses.py``).

* ``l1_loss`` / ``l1_loss_masked`` — utils/loss_utils.py:27-31 (the masked
  variant normalizes by *all* elements, not the mask sum);
* ``compute_scale_and_shift`` — train.py:198-221 (MiDaS closed-form least
  squares for per-image scale/shift);
* ``gradient_loss`` — train.py:232-249 with image-based reduction;
* ``depth_loss_ref`` / ``depth_loss_other`` — the composite depth terms of
  train.py:535-573 with the |scale| guard and the 4-level multiscale
  smoothness pyramid.

* ``l2_loss`` and ``inverse_depth_smoothness`` — the rest of the
  reference loss library (unused by its run configuration).

Images are (C,H,W); depths and masks (H,W) or (1,H,W).  The L1 terms
take bfloat16 images (the ``loss_dtype="bfloat16"`` loss head): the
differences stay in the image's dtype and the means accumulate in at
least float32 (``_acc_dtype``, losses.py:24-37).

``|x|`` is :func:`_abs`, whose gradient at 0 is +1 as JAX's is
(``torch.abs`` gives 0 there): flat regions, where forward differences
are exactly 0, are common in a render.
"""
from __future__ import annotations

import torch


def _abs(x):
    return torch.where(x >= 0, x, -x)


def _acc_dtype(x):
    """The dtype a mean accumulates in: at least float32 (float32 under
    bfloat16, float64 stays float64)."""
    return torch.promote_types(x.dtype, torch.float32)


def l1_loss(pred, gt):
    return torch.mean(_abs(pred - gt), dtype=_acc_dtype(pred))


def l1_loss_masked(pred, gt, mask):
    return torch.mean(_abs(pred - gt) * mask.to(pred.dtype),
                      dtype=_acc_dtype(pred))


def l2_loss(pred, gt):
    return torch.mean((pred - gt) ** 2)


def psnr(pred, gt, mask=None):
    """utils/image_utils.py:22-33 (20·log10(1/√mse))."""
    if mask is None:
        mse = torch.mean((pred - gt) ** 2)
    else:
        mask = torch.broadcast_to(mask, pred.shape)
        mse = torch.sum(((pred - gt) * mask) ** 2) / torch.clamp_min(
            torch.sum(mask), 1.0)
    return 20.0 * torch.log10(1.0 / torch.sqrt(torch.clamp_min(mse, 1e-12)))


def compute_scale_and_shift(prediction, target, mask):
    """Closed-form (s, t) minimising ‖mask·(s·pred + t − target)‖² over
    (H,W) inputs; a singular system yields (0, 0) as in the reference."""
    a00 = torch.sum(mask * prediction * prediction)
    a01 = torch.sum(mask * prediction)
    a11 = torch.sum(mask)
    b0 = torch.sum(mask * prediction * target)
    b1 = torch.sum(mask * target)
    det = a00 * a11 - a01 * a01
    ok = det != 0.0
    zero = torch.zeros_like(det)
    safe = torch.where(ok, det, torch.ones_like(det))
    s = torch.where(ok, (a11 * b0 - a01 * b1) / safe, zero)
    t = torch.where(ok, (-a01 * b0 + a00 * b1) / safe, zero)
    return s, t


def gradient_loss(prediction, target, mask):
    """Masked forward-difference loss, image-based reduction
    (train.py:224-249)."""
    diff = (prediction - target) * mask
    gx = _abs(diff[:, 1:] - diff[:, :-1]) * (mask[:, 1:] * mask[:, :-1])
    gy = _abs(diff[1:, :] - diff[:-1, :]) * (mask[1:, :] * mask[:-1, :])
    m = torch.sum(mask)
    total = torch.sum(gx) + torch.sum(gy)
    return torch.where(m > 0, total / torch.clamp_min(m, 1.0),
                       torch.zeros_like(total))


def multiscale_gradient_loss(aligned_depth, target_depth, mask,
                             levels: int = 4):
    """Σ_{s=0..3} gradient_loss at stride 2^s (train.py:553-556, 571-573)."""
    loss = 0.0
    for s in range(levels):
        step = 2 ** s
        loss = loss + gradient_loss(aligned_depth[::step, ::step],
                                    target_depth[::step, ::step],
                                    mask[::step, ::step])
    return loss


def align_depth(depth, midas_depth, valid_mask):
    """|s|·depth + t with (s,t) fit on the valid region (train.py:546-551,
    with the abs() guard against a negative scale)."""
    s, t = compute_scale_and_shift(depth, midas_depth, valid_mask)
    return _abs(s) * depth + t


def depth_loss_ref(depth, midas_depth, gt_mask, fg_mask, w_depth: float,
                   w_depth_fg: float, w_smooth: float):
    """Reference-view depth term (train.py:544-556): scale/shift fit on
    the background, L1 over the full image, an extra term over a box
    around the mask, unmasked multiscale smoothness."""
    valid = 1.0 - gt_mask
    aligned = align_depth(depth, midas_depth, valid)
    loss = w_depth * l1_loss(aligned, midas_depth)
    if w_depth_fg > w_depth:
        loss = loss + (w_depth_fg - w_depth) * l1_loss_masked(
            aligned, midas_depth, fg_mask)
    loss = loss + 0.5 * w_smooth * multiscale_gradient_loss(
        aligned, midas_depth, torch.ones_like(gt_mask))
    return loss


def depth_loss_other(depth, midas_depth, gt_mask, w_depth: float,
                     w_smooth: float):
    """Non-reference-view depth term (train.py:560-573): masked to the
    background for the L1 and the smoothness pyramid."""
    valid = 1.0 - gt_mask
    aligned = align_depth(depth, midas_depth, valid)
    loss = w_depth * l1_loss_masked(aligned, midas_depth, valid)
    loss = loss + 0.5 * w_smooth * multiscale_gradient_loss(
        aligned, midas_depth, valid)
    return loss


def inverse_depth_smoothness(idepth, image, mask=None):
    """Image-aware inverse-depth smoothness (kornia semantics; JAX
    losses.py:136-162, the reference's ``inverse_depth_smoothness_loss``
    and its masked ``_spatial`` variant): ``|∂x d|·exp(−mean_c|∂x I|) +
    |∂y d|·exp(−mean_c|∂y I|)``, each term mean-reduced over its (H, W−1)
    / (H−1, W) grid, with forward differences ``d[..., :-1] − d[...,
    1:]``.  ``idepth`` (H, W), ``image`` (3, H, W); ``mask`` (H, W), if
    given, multiplies the terms before the (unmasked) means."""
    dx_d = _abs(idepth[:, :-1] - idepth[:, 1:])
    dy_d = _abs(idepth[:-1, :] - idepth[1:, :])
    wx = torch.exp(-torch.mean(_abs(image[:, :, :-1] - image[:, :, 1:]),
                               dim=0))
    wy = torch.exp(-torch.mean(_abs(image[:, :-1, :] - image[:, 1:, :]),
                               dim=0))
    sx = dx_d * wx
    sy = dy_d * wy
    if mask is not None:
        sx = sx * mask[:, :-1]
        sy = sy * mask[:-1, :]
    return torch.mean(sx) + torch.mean(sy)
