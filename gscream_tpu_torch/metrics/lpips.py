"""LPIPS (VGG16 variant) as a PyTorch module (counterpart of
``gscream_tpu/metrics/lpips.py``).

The reference evaluates LPIPS with the ``lpips`` package's VGG16 net
(train.py:50-51, :948-953, including the masked spatial variant).  This
module computes the same function:

* the input scaling ``(x − shift) / scale`` of the LPIPS net on images
  mapped to [−1, 1];
* 13 3×3 convolutions with padding 1 (``_VGG_PLAN``), a 2×2 max-pool
  before convolutions 2, 4, 7 and 10 (``F.max_pool2d`` floors odd sizes
  as ``reduce_window`` VALID does), ReLU taps after convolutions 1, 3,
  6, 9 and 12;
* per layer: unit-normalization along channels, squared difference, the
  1×1 linear head, then the spatial mean, summed over the five layers.

The masked mode is the lpips package's *spatial* mode: each layer's map
is upsampled to the input size with ``F.interpolate(mode="bilinear",
align_corners=False, antialias=False)``, the maps are summed and the sum
is averaged inside ``mask > 0``.  JAX's ``jax.image.resize(...,
"linear")`` samples the same half-pixel grid, and the two agree only on
an upscale (on a downscale JAX antialiases); every tap is at or below
the input size, so here they agree.

The convolutions are cuDNN's (the JAX package leaves them to XLA, outside
any Pallas kernel); TF32 stays off (``precision.py``).

Weights are never fetched.  They load from an ``.npz`` at
``$GSCREAM_LPIPS_WEIGHTS`` or ``~/.cache/gscream/lpips_vgg.npz`` with
keys ``conv{i}_w``/``conv{i}_b`` (OIHW, i = 0..12) and ``lin{j}_w``
(j = 0..4, shape (C_j,)), the file ``tools/export_lpips.py`` writes for
both packages.  Without one, :func:`lpips_available` is False and the
evaluation reports LPIPS as null, never a number from other weights.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# VGG16 conv plan: (out_channels, pool_before)
_VGG_PLAN = [(64, False), (64, False),
             (128, True), (128, False),
             (256, True), (256, False), (256, False),
             (512, True), (512, False), (512, False),
             (512, True), (512, False), (512, False)]
# indices (into conv outputs) whose relu activations feed LPIPS
_TAP_AFTER = [1, 3, 6, 9, 12]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPSNet(nn.Module):
    """The VGG16 trunk and the five 1×1 heads of LPIPS."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 3
        for cout, _ in _VGG_PLAN:
            convs.append(nn.Conv2d(cin, cout, 3, padding=1))
            cin = cout
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ModuleList(
            nn.Conv2d(_VGG_PLAN[t][0], 1, 1, bias=False) for t in _TAP_AFTER)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    @classmethod
    def from_npz(cls, path: str) -> "LPIPSNet":
        z = np.load(path)
        net = cls()
        with torch.no_grad():
            for i, conv in enumerate(net.convs):
                conv.weight.copy_(torch.from_numpy(z[f"conv{i}_w"]))
                conv.bias.copy_(torch.from_numpy(z[f"conv{i}_b"]))
            for j, lin in enumerate(net.lins):
                lin.weight.copy_(
                    torch.from_numpy(z[f"lin{j}_w"]).view(1, -1, 1, 1))
        return net.eval().requires_grad_(False)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(N,3,H,W) in [−1, 1] → the five tap activations."""
        h = (x - self.shift) / self.scale
        taps = []
        for i, (conv, (_, pool)) in enumerate(zip(self.convs, _VGG_PLAN)):
            if pool:
                h = F.max_pool2d(h, 2, 2)
            h = F.relu(conv(h))
            if i in _TAP_AFTER:
                taps.append(h)
        return taps

    def layer_maps(self, img0: torch.Tensor,
                   img1: torch.Tensor) -> List[torch.Tensor]:
        """(3,H,W) images in [0, 1] → each layer's (h, w) distance map
        (both images go through the trunk as one batch of two)."""
        feats = self.features(torch.stack([img0, img1]) * 2.0 - 1.0)
        maps = []
        for f, lin in zip(feats, self.lins):
            f = f / (torch.sqrt(torch.sum(f * f, 1, keepdim=True)) + 1e-10)
            maps.append(lin((f[0:1] - f[1:2]) ** 2)[0, 0])
        return maps


def _weights_path() -> Optional[str]:
    cand = [os.environ.get("GSCREAM_LPIPS_WEIGHTS", ""),
            os.path.expanduser("~/.cache/gscream/lpips_vgg.npz")]
    for c in cand:
        if c and os.path.exists(c):
            return c
    return None


_CACHE: Dict[Tuple[str, str], LPIPSNet] = {}


def lpips_available() -> bool:
    return _weights_path() is not None


def load_weights(device="cpu") -> LPIPSNet:
    """The network of the weight file found now, on ``device`` (cached per
    path and device)."""
    path = _weights_path()
    if path is None:
        raise FileNotFoundError(
            "LPIPS weights not found; export them with tools/export_lpips.py"
            " and set GSCREAM_LPIPS_WEIGHTS")
    key = (path, str(torch.device(device)))
    if key not in _CACHE:
        _CACHE[key] = LPIPSNet.from_npz(path).to(device)
    return _CACHE[key]


@torch.no_grad()
def lpips(img0: torch.Tensor, img1: torch.Tensor,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LPIPS distance between (3,H,W) images in [0, 1], on their device.

    ``mask`` (H,W): the reference's masked LPIPS (train.py:951-953), the
    spatial mode's map averaged inside ``mask > 0``."""
    maps = load_weights(img0.device).layer_maps(img0, img1)
    if mask is None:
        return sum(torch.mean(m) for m in maps)
    hw = img0.shape[-2:]
    total = sum(F.interpolate(m[None, None], size=hw, mode="bilinear",
                              align_corners=False, antialias=False)[0, 0]
                for m in maps)
    mm = (mask > 0).to(total.dtype)
    return torch.sum(total * mm) / torch.clamp_min(torch.sum(mm), 1.0)
