"""GScream's training objective (``train.py`` of GScream, with the loss
weights of its ``scripts/run.py``): on the reference view, L1 + D-SSIM
over the image plus a heavier term inside the object mask, and the
monocular depth aligned by a least-squares scale and shift on the
background; on the other views, the same terms outside the mask.

The SSIM is the 3DGS training SSIM: an 11×11 gaussian window (σ = 1.5),
zero padding, C1 = 0.01², C2 = 0.03².  The masked means divide by every
pixel, not by the mask's sum, as GScream's ``loss_utils`` do.

Departures: |x| has the gradient +1 at 0 (``torch.abs`` gives 0), and the
SSIM variances are clamped at 0 from below.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

C1, C2 = 0.01 ** 2, 0.03 ** 2


def _abs(x):
    return torch.where(x >= 0, x, -x)


def _window(n=11, sigma=1.5, device="cpu"):
    xs = np.arange(n) - n // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return torch.tensor((g / g.sum()).astype(np.float32), device=device)


def _blur(img, k):
    c, half = img.shape[0], k.shape[0] // 2
    x = F.conv2d(img[None], k.reshape(1, 1, -1, 1).expand(c, 1, -1, 1),
                 padding=(half, 0), groups=c)
    return F.conv2d(x, k.reshape(1, 1, 1, -1).expand(c, 1, 1, -1),
                    padding=(0, half), groups=c)[0]


def ssim_map(a, b):
    k = _window(device=a.device)
    mu1, mu2 = _blur(a, k), _blur(b, k)
    zero = torch.zeros_like(mu1)
    s1 = torch.maximum(_blur(a * a, k) - mu1 * mu1, zero)
    s2 = torch.maximum(_blur(b * b, k) - mu2 * mu2, zero)
    s12 = _blur(a * b, k) - mu1 * mu2
    return ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / (
        (mu1 * mu1 + mu2 * mu2 + C1) * (s1 + s2 + C2))


def l1(a, b, w=None):
    d = _abs(a - b)
    return torch.mean(d if w is None else d * w)


def _scale_shift(pred, target, mask):
    a00 = torch.sum(mask * pred * pred)
    a01 = torch.sum(mask * pred)
    a11 = torch.sum(mask)
    b0 = torch.sum(mask * pred * target)
    b1 = torch.sum(mask * target)
    det = a00 * a11 - a01 * a01
    ok = det != 0.0
    safe = torch.where(ok, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    s = torch.where(ok, (a11 * b0 - a01 * b1) / safe, zero)
    t = torch.where(ok, (-a01 * b0 + a00 * b1) / safe, zero)
    return s, t


def _gradient_loss(pred, target, mask):
    d = (pred - target) * mask
    gx = _abs(d[:, 1:] - d[:, :-1]) * (mask[:, 1:] * mask[:, :-1])
    gy = _abs(d[1:, :] - d[:-1, :]) * (mask[1:, :] * mask[:-1, :])
    m = torch.sum(mask)
    tot = torch.sum(gx) + torch.sum(gy)
    return torch.where(m > 0, tot / torch.clamp_min(m, 1.0),
                       torch.zeros_like(tot))


def _multiscale(aligned, target, mask):
    return sum(_gradient_loss(aligned[::s, ::s], target[::s, ::s],
                              mask[::s, ::s]) for s in (1, 2, 4, 8))


def view_loss(img, depth, gt, mask, mono, fg_box, w, is_ref: bool):
    """(loss, l1) of one view.  ``img``, ``gt`` (3,H,W); ``depth``,
    ``mono``, ``fg_box`` (H,W); ``mask`` (1,H,W); ``w`` the run's loss
    weights (``lambda_dssim``, ``refer_*``, ``other_*``)."""
    lam = w["lambda_dssim"]
    m0 = mask[0]
    bgm = 1.0 - m0
    if is_ref:
        l1v = l1(img, gt)
        loss = w["refer_rgb_lr"] * ((1 - lam) * l1v + lam * (
            1 - torch.mean(ssim_map(img, gt))))
        if w["refer_rgb_lr_fg"] > w["refer_rgb_lr"]:
            loss = loss + (w["refer_rgb_lr_fg"] - w["refer_rgb_lr"]) * (
                (1 - lam) * l1(img, gt, mask)
                + lam * (1 - torch.mean(ssim_map(img, gt) * mask)))
        if w["refer_depth_lr"] > 0:
            s, t = _scale_shift(depth, mono, bgm)
            al = _abs(s) * depth + t
            loss = loss + w["refer_depth_lr"] * l1(al, mono)
            if w["refer_depth_lr_fg"] > w["refer_depth_lr"]:
                loss = loss + (w["refer_depth_lr_fg"]
                               - w["refer_depth_lr"]) * l1(al, mono, fg_box)
            loss = loss + 0.5 * w["refer_depth_lr_smooth"] * _multiscale(
                al, mono, torch.ones_like(m0))
    else:
        wm = bgm[None] + w["other_rgb_lr_fg"] * mask
        l1v = l1(img, gt, wm)
        loss = w["other_rgb_lr"] * ((1 - lam) * l1v + lam * (
            1 - torch.mean(ssim_map(img, gt) * wm)))
        if w["other_depth_lr"] > 0:
            s, t = _scale_shift(depth, mono, bgm)
            al = _abs(s) * depth + t
            loss = loss + w["other_depth_lr"] * l1(al, mono, bgm)
            loss = loss + 0.5 * w["other_depth_lr_smooth"] * _multiscale(
                al, mono, bgm)
    return loss, l1v
