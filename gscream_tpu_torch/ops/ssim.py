"""Training-loss SSIM (counterpart of ``ssim`` / ``ssim_masked`` of
``gscream_tpu/ops/ssim.py``; reference utils/loss_utils.py:131-199):
11×11 gaussian window (σ=1.5), per-channel blur with **zero** padding of
window//2, C1=0.01², C2=0.03²; the masked variant multiplies the map by
the mask before the global mean.

The separable blur is two grouped ``F.conv2d`` calls, as the JAX package
leaves it to XLA's convolution: no kernel of the repo's own.  cuDNN's
TF32 is off (``precision.py``).  Images are (C,H,W) float32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _gaussian_kernel(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Depthwise separable blur with zero padding, vertical then
    horizontal (``_filter2d`` of the JAX package)."""
    c = img.shape[0]
    half = k1d.shape[0] // 2
    x = F.conv2d(img[None], k1d.reshape(1, 1, -1, 1).expand(c, 1, -1, 1),
                 padding=(half, 0), groups=c)
    x = F.conv2d(x, k1d.reshape(1, 1, 1, -1).expand(c, 1, 1, -1),
                 padding=(0, half), groups=c)
    return x[0]


def _ssim_map(img1, img2, window_size: int = 11, sigma: float = 1.5):
    k = torch.as_tensor(_gaussian_kernel(window_size, sigma),
                        device=img1.device)
    mu1 = _blur(img1, k)
    mu2 = _blur(img2, k)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    # variances are >= 0 in exact arithmetic; the E[x²]−μ² cancellation
    # can make them slightly negative.  torch.maximum (not clamp_min)
    # splits the gradient at a tie as JAX's maximum does.
    zero = torch.zeros_like(mu1)
    s1 = torch.maximum(_blur(img1 * img1, k) - mu1_sq, zero)
    s2 = torch.maximum(_blur(img2 * img2, k) - mu2_sq, zero)
    s12 = _blur(img1 * img2, k) - mu12
    return ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Training SSIM (loss_utils.py:139-168): zero padding, mean."""
    return torch.mean(_ssim_map(img1, img2, window_size))


def ssim_masked(img1: torch.Tensor, img2: torch.Tensor, mask: torch.Tensor,
                window_size: int = 11) -> torch.Tensor:
    """Masked training SSIM (loss_utils.py:172-199): map·mask, then the
    mean over *all* pixels (the reference's normalization)."""
    return torch.mean(_ssim_map(img1, img2, window_size) * mask)
