"""SSIM variants (counterpart of ``gscream_tpu/ops/ssim.py``):

* :func:`ssim` / :func:`ssim_masked` — the training-loss SSIM
  (reference utils/loss_utils.py:131-199): 11×11 gaussian window
  (σ=1.5), per-channel blur with **zero** padding of window//2,
  C1=0.01², C2=0.03²; the masked variant multiplies the map by the mask
  before the global mean.
* :func:`kornia_ssim_map` / :func:`my_ssim` — the evaluation SSIM
  (loss_utils.py:123-128, 381-441): kornia's ``metrics.ssim`` with a
  5-tap window, σ=1.5 and *reflect* padding (``F.pad(mode="reflect")``
  excludes the edge pixel, as numpy's "reflect" does; torch's
  "replicate" and numpy's "symmetric" are other paddings);
  ``my_ssim = 1 − 2·mean(clamp((1−map)/2, 0, 1))``, optionally over a
  mask.

The training blur is two grouped ``F.conv2d`` calls, as the JAX package
leaves it to XLA's convolution: no kernel of the repo's own; the
evaluation blur sums its five taps in XLA's order (:func:`_blur_reflect`).  cuDNN's
TF32 is off (``precision.py``).  Images are (C,H,W) float32, or bfloat16
in the training SSIM (the ``loss_dtype="bfloat16"`` loss head): the
window then is bfloat16 too, and the means accumulate in float32
(ssim.py:41-43, :82, :90).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import device_constant

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


def _pairwise_sum(terms):
    """Neighbours added pairwise, level by level, the odd one last."""
    while len(terms) > 1:
        pairs = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        terms = pairs + terms[len(pairs) * 2:]
    return terms[0]


def _blur_reflect(img: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """The evaluation blur: the image reflect-padded once, then VALID
    vertical and horizontal passes (``_filter2d(..., "reflect")``).  Each
    pass is the taps' rounded products summed pairwise, the order XLA's
    CPU convolution uses, so the port's blur is bit-equal to the JAX
    package's on the CPU and, made of elementwise operations, to itself
    on the card.  (Any other order moves a blur by an ulp, which the SSIM
    map's E[xy] − μxμy cancellation turns into ~1e-5.)"""
    n = k1d.shape[0]
    half = n // 2
    x = F.pad(img[None], (half, half, half, half), mode="reflect")[0]
    h, w = img.shape[1:]
    x = _pairwise_sum([x[:, i:i + h, :] * k1d[i] for i in range(n)])
    return _pairwise_sum([x[:, :, i:i + w] * k1d[i] for i in range(n)])


def _ssim_map(img1, img2, window_size: int = 11, sigma: float = 1.5,
              padding: str = "zero", c1: float = C1, c2: float = C2):
    # the window follows the image's dtype, so a bfloat16 map stays one;
    # made once per device (a host copy inside a step would wait for it)
    k = device_constant(tuple(_gaussian_kernel(window_size, sigma)),
                        img1.device).to(img1.dtype)
    blur = functools.partial(_blur_reflect if padding == "reflect"
                             else _blur, k1d=k)
    mu1 = blur(img1)
    mu2 = blur(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    # variances are >= 0 in exact arithmetic; the E[x²]−μ² cancellation
    # can make them slightly negative.  torch.maximum (not clamp_min)
    # splits the gradient at a tie as JAX's maximum does.
    zero = torch.zeros_like(mu1)
    s1 = torch.maximum(blur(img1 * img1) - mu1_sq, zero)
    s2 = torch.maximum(blur(img2 * img2) - mu2_sq, zero)
    s12 = blur(img1 * img2) - mu12
    return ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Training SSIM (loss_utils.py:139-168): zero padding, mean (in at
    least float32)."""
    m = _ssim_map(img1, img2, window_size)
    return torch.mean(m, dtype=torch.promote_types(m.dtype, torch.float32))


def ssim_masked(img1: torch.Tensor, img2: torch.Tensor, mask: torch.Tensor,
                window_size: int = 11) -> torch.Tensor:
    """Masked training SSIM (loss_utils.py:172-199): map·mask, then the
    mean over *all* pixels (the reference's normalization)."""
    m = _ssim_map(img1, img2, window_size)
    return torch.mean(m * mask.to(m.dtype),
                      dtype=torch.promote_types(m.dtype, torch.float32))


def kornia_ssim_map(img1: torch.Tensor, img2: torch.Tensor,
                    window_size: int = 5,
                    max_val: float = 1.0) -> torch.Tensor:
    """kornia.metrics.ssim map: gaussian window σ=1.5, reflect padding."""
    return _ssim_map(img1, img2, window_size, 1.5, "reflect",
                     (0.01 * max_val) ** 2, (0.03 * max_val) ** 2)


def my_ssim(img_pred: torch.Tensor, img_gt: torch.Tensor,
            mask=None) -> torch.Tensor:
    """Evaluation SSIM (loss_utils.py:123-128): 1 − 2·dssim ∈ [−1, 1].

    ``mask`` ((1,H,W) or (H,W)) restricts the mean to the entries where
    it is > 0, broadcast over the channels, divided by max(Σmask, 1)."""
    dssim = torch.clamp((1.0 - kornia_ssim_map(img_pred, img_gt)) / 2.0,
                        0.0, 1.0)
    if mask is None:
        d = torch.mean(dssim)
    else:
        m = (mask.reshape(1, *mask.shape[-2:]) > 0).expand_as(dssim)
        m = m.to(dssim.dtype)
        d = torch.sum(dssim * m) / torch.clamp_min(torch.sum(m), 1.0)
    return 1.0 - 2.0 * d
