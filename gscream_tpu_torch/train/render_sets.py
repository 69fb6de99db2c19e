"""Render-set harness (counterpart of ``gscream_tpu/train/render_sets.py``).

Renders every view of a split through the port's render path — decode,
preprocess, row-tight binning, tile forward — and saves RGB renders,
depth maps (viridis PNG plus raw ``.npy`` for the train split) and, when
ground truth is given, gt and error maps; FPS is ``1/mean(per-view wall
time)`` skipping the first 5 views (reference train.py:756-763, 861-882),
each view timed to a ``torch.cuda.synchronize()``.

The spiral split also writes inferno depth PNGs, normal maps from the
rendered depth (:func:`normals_from_depth`, on the depth's device) and
``video.{mp4,avi}`` at 30 fps (``utils/video.py``).

The instance capacity is fixed by the caller, as in the JAX package; the
render function also returns each view's ``overflow_demand`` so the caller
can size the capacity with ``train.loop.capacity_tier`` and see when a
view was truncated.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..cameras import Camera
from ..model.scaffold import ScaffoldConfig, ScaffoldState, decode
from ..ops.binning import bin_instances, overflow_demand
from ..ops.projection import preprocess
from ..ops.rasterize_tiled import TILE_H, TILE_W, rasterize_tiled
from ..utils.png import write_png
from ..utils.video import write_video


def make_render_fn(scaffold: ScaffoldState, cfg: ScaffoldConfig,
                   width: int, height: int, capacity: int, white_bg=False):
    """``render(params, mlps, cam) -> (TiledOut, visible, demand)``:
    ``visible`` counts gaussians with radius > 0, ``demand`` is the
    binning's :func:`overflow_demand` (> ``capacity`` ⇒ truncated)."""
    dev = scaffold.alive.device
    bg = torch.ones(3, device=dev) if white_bg else torch.zeros(3,
                                                                 device=dev)

    @torch.no_grad()
    def render(params, mlps, cam: Camera):
        # the record_function ranges name the layers in a torch.profiler
        # trace (chip_smoke.py reads them); outside a profiler they are
        # inert
        st = scaffold._replace(params=params, mlps=mlps)
        with record_function("render/decode"):
            dec = decode(st, cam.cam_center, None, cfg)
        with record_function("render/preprocess"):
            splats = preprocess(
                dec.xyz, dec.scale, dec.rot, cam.w2c, cam.full_proj,
                width, height, cam.tan_fovx, cam.tan_fovy,
                tile_w=TILE_W, tile_h=TILE_H, active_mask=dec.active,
                opacity=dec.opacity)
        with record_function("render/bin_instances"):
            binning = bin_instances(splats, capacity, width, height,
                                    TILE_W, TILE_H)
        with record_function("render/rasterize_tiled"):
            out = rasterize_tiled(splats.mean2d, splats.conic, dec.opacity,
                                  dec.color, splats.depth, dec.uncertainty,
                                  binning, bg, width, height)
        visible = torch.sum((splats.radius > 0).to(torch.int32))
        return out, visible, overflow_demand(binning)

    return render


def _save_png(path: str, img: np.ndarray) -> None:
    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, -1)
    write_png(path, np.ascontiguousarray(arr[..., :3]))


def _viridis(depth: np.ndarray) -> np.ndarray:
    """Normalized depth → viridis RGB (grayscale without matplotlib)."""
    d = depth - depth.min()
    d = d / max(d.max(), 1e-9)
    try:
        import matplotlib.cm as cm
        return np.asarray(cm.viridis(d))[..., :3]
    except Exception:
        return np.stack([d, d, d], -1)


def _inferno(depth: np.ndarray) -> np.ndarray:
    """Spiral depth colormap: max-normalize then INFERNO (reference
    train.py:806-809, cv2.COLORMAP_INFERNO); grey without matplotlib."""
    d = depth / max(depth.max(), 1e-9)
    try:
        import matplotlib.cm as cm
        return np.asarray(cm.inferno(d))[..., :3]
    except ImportError:
        return np.stack([d, d, d], -1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_set(out_dir: str, split_name: str, cameras: List[Camera],
               scaffold: ScaffoldState, cfg: ScaffoldConfig,
               capacity: int = 1 << 21, save_images: bool = True,
               gt_images: Optional[List[np.ndarray]] = None) -> Dict:
    """Render every camera; returns {"fps", "renders", "visible_counts",
    "overflow_demand"} (renders as (3,H,W) numpy arrays).  The device is
    the scaffold's; cameras must live on it too."""
    if not cameras:
        return {"fps": 0.0, "renders": [], "visible_counts": [],
                "overflow_demand": []}
    dev = scaffold.alive.device
    width, height = cameras[0].width, cameras[0].height
    render = make_render_fn(scaffold, cfg, width, height, capacity)
    rdir = os.path.join(out_dir, split_name, "renders")
    ddir = os.path.join(out_dir, split_name, "depth")
    if save_images:
        os.makedirs(rdir, exist_ok=True)
        os.makedirs(ddir, exist_ok=True)
    is_spiral = split_name == "spiral"
    ndir = os.path.join(out_dir, split_name, "normal")
    if save_images and is_spiral:
        os.makedirs(ndir, exist_ok=True)

    times, renders, counts, demands = [], [], [], []
    for idx, cam in enumerate(cameras):
        _sync(dev)
        t0 = time.perf_counter()
        out, visible, demand = render(scaffold.params, scaffold.mlps, cam)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        color = out.color.cpu().numpy()
        img = color.transpose(2, 0, 1)
        renders.append(img)
        counts.append(int(visible))
        demands.append(int(demand))
        if demands[-1] > capacity:
            print(f"WARNING: {split_name} view {idx}: instance demand "
                  f"{demands[-1]} exceeds capacity {capacity}; the render "
                  "is truncated (raise --instance_capacity)",
                  file=sys.stderr)
        if save_images:
            _save_png(os.path.join(rdir, f"{idx:05d}.png"), color)
            depth = out.depth.cpu().numpy()
            _save_png(os.path.join(ddir, f"{idx:05d}.png"),
                      _inferno(depth) if is_spiral else _viridis(depth))
            if split_name == "train":
                np.save(os.path.join(ddir, f"{idx:05d}.npy"), depth)
            if is_spiral:
                # spiral-only normal maps from the rendered depth
                # (reference train.py:820-825 → 252-298)
                nrm = normals_from_depth(out.depth, *camera_c2w_K(cam))
                _save_png(os.path.join(ndir, f"{idx:05d}.png"),
                          (nrm.permute(1, 2, 0).cpu().numpy() + 1.0) * 0.5)
            if (gt_images is not None and idx < len(gt_images)
                    and gt_images[idx] is not None):
                gdir = os.path.join(out_dir, split_name, "gt")
                edir = os.path.join(out_dir, split_name, "errors")
                os.makedirs(gdir, exist_ok=True)
                os.makedirs(edir, exist_ok=True)
                gt = np.asarray(gt_images[idx])
                _save_png(os.path.join(gdir, f"{idx:05d}.png"),
                          gt.transpose(1, 2, 0))
                err = np.abs(img - gt).mean(0)
                _save_png(os.path.join(edir, f"{idx:05d}.png"),
                          np.stack([err] * 3, -1))
    # FPS skipping 5 warmup frames (train.py:861)
    t = times[5:] if len(times) > 5 else times
    fps = 1.0 / float(np.mean(t)) if t else 0.0
    if save_images:
        with open(os.path.join(out_dir, split_name,
                               "per_view_count.json"), "w") as f:
            json.dump({f"{i:05d}": c for i, c in enumerate(counts)}, f)
        if is_spiral:
            # the reference ffmpeg-encodes an mp4 (train.py:844-846)
            write_video(os.path.join(out_dir, split_name, "video"),
                        [r.transpose(1, 2, 0) for r in renders], fps=30)
    return {"fps": fps, "renders": renders, "visible_counts": counts,
            "overflow_demand": demands}


def camera_c2w_K(cam: Camera):
    """(c2w (4,4), K (3,3)) of a camera, as numpy on the host: the
    inverse of its float32 w2c and the pinhole intrinsics of the JAX
    render set (render_sets.py:123-128)."""
    c2w = np.linalg.inv(cam.w2c.cpu().numpy())
    fx = cam.width / (2.0 * float(cam.tan_fovx))
    fy = cam.height / (2.0 * float(cam.tan_fovy))
    K = np.array([[fx, 0, cam.width / 2.0], [0, fy, cam.height / 2.0],
                  [0, 0, 1.0]])
    return c2w, K


def normals_from_depth(depth: torch.Tensor, c2w: np.ndarray, K: np.ndarray,
                       size: int = 9, gamma: float = 0.15) -> torch.Tensor:
    """Depth (H,W) → per-pixel normals (3,H,W) on the depth's device, by
    local plane fits (the reference's ``depth2pcd_fromplane`` +
    ``least_square_normal_regress_fast01``, train.py:252-298; JAX's numpy
    ``normals_from_depth``).

    The same function as JAX's: the pixels unprojected (in float64,
    rounded to float32) to world points; over a ``size``×``size`` window
    with edge padding, a neighbour whose relative z difference from the
    centre exceeds ``gamma`` is zeroed; AtA = Σ p pᵀ and Atb = Σ p over
    the window (float32, as JAX sums them); AtA reset to I where
    det(AtA) < 1e-5; n = solve(AtA, Atb), normalized, NaN set to 0,
    negated.  JAX gathers an (H, W, 81, 3) window array (~1 GB at
    1297×840); here the sums run over the 81 offsets one at a time, left
    to right, so memory stays a few (H, W) planes.  The 81 points of a
    window lie close together far from the origin, so AtA is nearly rank
    one (condition ~1e4-1e5 at 1297×840): a float32 LU solve, JAX's,
    scatters the normal by ~cond·6e-8.  Here det and solve are closed
    forms in float64, so the result depends on no LAPACK or cuBLAS
    order and every step is elementwise: the card's normals are the
    CPU's bit for bit.  Against JAX, a det or rejection threshold and
    the float32 solve's error move a few pixels
    (``tests/test_torch_spiral.py`` states the share it allows)."""
    h, w = depth.shape
    dev = depth.device
    f64 = torch.float64
    c2w = torch.as_tensor(np.asarray(c2w, np.float64), device=dev)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=f64, device=dev),
                            torch.arange(w, dtype=f64, device=dev),
                            indexing="ij")
    fx, fy, cx, cy = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]),
                      float(K[1, 2]))
    d = depth.to(f64)
    cam = ((xs - cx) / fx * d, (ys - cy) / fy * d, d)
    pts = torch.stack([c2w[r, 0] * cam[0] + c2w[r, 1] * cam[1]
                       + c2w[r, 2] * cam[2] + c2w[r, 3]
                       for r in range(3)]).to(torch.float32)
    half = size // 2
    pad = torch.nn.functional.pad(pts[None], (half, half, half, half),
                                  mode="replicate")[0]
    cz = pts[2]
    cz_safe = torch.where(torch.abs(cz) > 1e-9, cz,
                          torch.full_like(cz, 1e-9))
    ata = torch.zeros((3, 3, h, w), device=dev)
    atb = torch.zeros((3, h, w), device=dev)
    for dy in range(size):
        for dx in range(size):
            p = pad[:, dy:dy + h, dx:dx + w]
            bad = torch.abs((p[2] - cz) / cz_safe) > gamma
            p = torch.where(bad, torch.zeros_like(p), p)
            atb += p
            ata += p[:, None] * p[None, :]
    # the 3×3 solve in closed form, in float64: cofactors C, det = Σ a0j
    # C0j, n = Cᵀ b / det (b itself where det < 1e-5, the solve with I)
    a = ata.to(f64)
    b = atb.to(f64)
    cof = [[a[(i + 1) % 3][(j + 1) % 3] * a[(i + 2) % 3][(j + 2) % 3]
            - a[(i + 1) % 3][(j + 2) % 3] * a[(i + 2) % 3][(j + 1) % 3]
            for j in range(3)] for i in range(3)]
    det = a[0][0] * cof[0][0] + a[0][1] * cof[0][1] + a[0][2] * cof[0][2]
    reset = det < 1e-5
    n = [torch.where(reset, b[i], (cof[0][i] * b[0] + cof[1][i] * b[1]
                                   + cof[2][i] * b[2]) / det)
         for i in range(3)]
    norm = torch.sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
    n = torch.stack(n) / torch.clamp_min(norm, 1e-12)
    return -torch.nan_to_num(n.to(torch.float32))
