"""Synthetic multi-view scenes for tests, demos and smoke runs
(counterpart of ``gscream_tpu/data/synthetic.py``).

The reference repo ships no scene data; this module builds a small
procedural scene whose ground truth the oracle rasterizer renders, so the
whole training loop — masked RGB losses, depth supervision,
densification, cross-attention — runs without a dataset.  The scene is
drawn from ``numpy.random.default_rng(seed)`` in the JAX module's order,
so both packages build the same scene from one seed.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from ..cameras import Camera, make_camera
from ..device import resolve_device
from ..ops.projection import preprocess
from ..ops.rasterize_ref import rasterize_scan


class SyntheticView(NamedTuple):
    camera: Camera
    image: np.ndarray        # (3,H,W) float32
    mask: np.ndarray         # (1,H,W) float32 — "object" region
    depth: np.ndarray        # (1,H,W) float32 — mono-style (affine) depth
    name: str


class SyntheticScene(NamedTuple):
    views: List[SyntheticView]
    points: np.ndarray       # (N,3) init cloud
    ref_index: int


def _orbit_camera(angle: float, radius: float, width: int, height: int,
                  fov: float = 1.0, device="cuda") -> Camera:
    """Camera on a circle in the x-z plane looking at the origin."""
    eye = np.array([radius * math.sin(angle), 0.0,
                    -radius * math.cos(angle)])
    fwd = -eye / np.linalg.norm(eye)          # toward origin
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    R_c2w = np.stack([right, true_up, fwd], axis=1)   # columns
    # reference stores R = c2w rotation; T = w2c translation
    T = -R_c2w.T @ eye
    return make_camera(R_c2w, T, fov, fov, width, height, device=device)


def make_scene(n_views: int = 6, n_gauss: int = 400, width: int = 64,
               height: int = 64, seed: int = 0, radius: float = 2.2,
               device="cuda") -> SyntheticScene:
    """A blob of gaussians at the origin viewed from an orbit.

    The targets come from the oracle rasterizer (on ``device``) on a
    random gaussian cloud; the "object mask" is the central box (the
    removal region's stand-in) and the mono depth an affine map of the
    rendered depth, positively correlated, as the reference's |scale|
    guard (train.py:548) assumes.  The blob fills most of the frame: a
    mostly black target makes "kill every gaussian" a strong local optimum
    of the masked L1 losses."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 0.55, (n_gauss, 3)).astype(np.float32)
    scales = rng.uniform(0.08, 0.2, (n_gauss, 3)).astype(np.float32)
    quats = rng.normal(size=(n_gauss, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    colors = rng.uniform(0, 1, (n_gauss, 3)).astype(np.float32)
    opac = rng.uniform(0.4, 0.9, n_gauss).astype(np.float32)
    unc = rng.uniform(0, 1, n_gauss).astype(np.float32)

    def t(x):
        return torch.as_tensor(x, device=dev)
    bg = torch.zeros(3, device=dev)
    views = []
    for i in range(n_views):
        cam = _orbit_camera(2 * math.pi * i / n_views, radius, width, height,
                            device=dev)
        with torch.no_grad():
            s = preprocess(t(pts), t(scales), t(quats), cam.w2c,
                           cam.full_proj, width, height, cam.tan_fovx,
                           cam.tan_fovy, tile_w=32, tile_h=32)
            out = rasterize_scan(s, t(colors), t(opac), t(unc), bg, width,
                                 height, tile_w=32, tile_h=32)
        img = out.color.cpu().numpy().transpose(2, 0, 1)
        depth = out.depth.cpu().numpy()
        mask = np.zeros((1, height, width), np.float32)
        mask[:, height // 3: 2 * height // 3,
             width // 3: 2 * width // 3] = 1.0
        d = depth / max(depth.max(), 1e-6)
        mono = (0.1 + 0.8 * d).astype(np.float32)[None]
        views.append(SyntheticView(camera=cam, image=img.astype(np.float32),
                                   mask=mask, depth=mono,
                                   name=f"view_{i:03d}"))
    # noisy init cloud (subset + jitter), a stand-in for COLMAP points
    sel = rng.choice(n_gauss, size=min(200, n_gauss), replace=False)
    init_pts = pts[sel] + rng.normal(0, 0.02, (len(sel), 3)).astype(
        np.float32)
    return SyntheticScene(views=views, points=init_pts, ref_index=0)
