"""Qualitative-dump visualization helpers (label / jet / normalization):
the port's copy of ``gscream_tpu/utils/visualize.py``, with cv2 imported
only where a caption is drawn.

Port of the reference's ``utils/visualize_utils.py:9-152`` surface —
``add_label_centered``, ``tensor2rgb``, ``tensor2rgbjet``, ``tensor2image``
and the depth→camera-space→normals chain — as plain numpy over (H, W[, C])
arrays (the torch tensors of the reference are device arrays; here
visualization is host-side post-processing, so numpy is the natural type).
cv2 is optional: the jet colormap is evaluated directly (the same
piecewise-linear map ``cv2.COLORMAP_JET`` implements), and text labels fall
back to a contrasting banner strip when cv2 is absent.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _cv2():
    """cv2 where it imports (absent on the card's machine), else None."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def to_rgb8(x: np.ndarray, x_max: Optional[float] = None,
            x_min: Optional[float] = None) -> np.ndarray:
    """Min-max normalize to uint8 (reference ``tensor2rgb``,
    visualize_utils.py:53-67): gain = 255 / clip(max-min, 1e-3)."""
    x = np.asarray(x, np.float32)
    lo = float(x.min()) if x_min is None else float(x_min)
    hi = float(x.max()) if x_max is None else float(x_max)
    gain = 255.0 / max(hi - lo, 1e-3)
    return np.clip((x - lo) * gain, 0.0, 255.0).astype(np.uint8)


def _jet(u8: np.ndarray) -> np.ndarray:
    """uint8 scalar field → RGB jet (the piecewise-linear colormap
    ``cv2.COLORMAP_JET`` applies; evaluated directly so the helper works
    without opencv).  Returns (..., 3) uint8 in RGB order."""
    v = u8.astype(np.float32) * (4.0 / 255.0)
    r = np.clip(np.minimum(v - 1.5, -v + 4.5), 0.0, 1.0)
    g = np.clip(np.minimum(v - 0.5, -v + 3.5), 0.0, 1.0)
    b = np.clip(np.minimum(v + 0.5, -v + 2.5), 0.0, 1.0)
    return (np.stack([r, g, b], axis=-1) * 255.0).astype(np.uint8)


def to_jet(x: np.ndarray, x_max: Optional[float] = None,
           x_min: Optional[float] = None) -> np.ndarray:
    """Normalize then jet-colormap (reference ``tensor2rgbjet``,
    visualize_utils.py:48-50)."""
    u8 = to_rgb8(x, x_max=x_max, x_min=x_min)
    if u8.ndim == 3 and u8.shape[-1] == 3:
        # reference applies the map per-channel on a 3-channel input
        return _jet(u8)
    return _jet(u8)


def add_label_centered(img: np.ndarray, text: str, font_scale: float = 1.0,
                       thickness: int = 2, alignment: str = "top",
                       color: Tuple[int, int, int] = (0, 255, 0)
                       ) -> np.ndarray:
    """Horizontally-centered caption at the top or bottom edge (reference
    ``add_label_centered``, visualize_utils.py:9-45).  Without cv2 the
    caption degrades to a thin banner strip in ``color`` (keeps dump
    layouts stable in minimal environments)."""
    if alignment not in ("top", "bottom"):
        raise ValueError("Unknown text alignment")
    img = np.ascontiguousarray(img.astype(np.uint8))
    cv2 = _cv2()
    if cv2 is not None:
        font = cv2.FONT_HERSHEY_SIMPLEX
        (tw, th), _ = cv2.getTextSize(text, font, font_scale, thickness)
        org = ((img.shape[1] - tw) // 2,
               50 if alignment == "top" else img.shape[0] - th)
        cv2.putText(img, text, org, font, font_scale, color,
                    thickness=thickness, lineType=cv2.LINE_AA)
        return img
    band = slice(0, 4) if alignment == "top" else slice(-4, None)
    img[band, :, ...] = np.asarray(color, np.uint8)[:img.shape[-1]] \
        if img.ndim == 3 else 255
    return img


def to_image(x: np.ndarray, x_max: Optional[float] = 1.0,
             x_min: Optional[float] = 0.0, mode: str = "rgb",
             mask: Optional[np.ndarray] = None,
             label: Optional[str] = None) -> np.ndarray:
    """(C,H,W) or (H,W) array → displayable (H,W,3) uint8 (reference
    ``tensor2image``, visualize_utils.py:70-112): optional mask multiply,
    1→3 channel repeat, rgb/jet mode, optional caption."""
    x = np.asarray(x, np.float32)
    if mask is not None:
        x = x * np.asarray(mask, np.float32)
    if x.ndim == 2:
        x = x[None]
    if x.ndim != 3:
        raise ValueError(f"Unsupported shape {x.shape}")
    if x.shape[0] == 1:
        x = np.repeat(x, 3, axis=0)
    elif x.shape[0] != 3:
        raise ValueError(f"Unsupported number of channels {x.shape[0]}.")
    img = x.transpose(1, 2, 0)
    if mode == "rgb":
        out = to_rgb8(img, x_max=x_max, x_min=x_min)
    elif mode == "jet":
        out = to_jet(img[..., 0], x_max=x_max, x_min=x_min)
    else:
        raise ValueError(f"Unsupported mode {mode}.")
    if label is not None:
        out = add_label_centered(out, label)
    return out


def depth_to_cam_points(depth: np.ndarray, focal: Tuple[float, float],
                        princpt: Tuple[float, float]) -> np.ndarray:
    """(H,W) depth → (3,H,W) camera-space positions via the pinhole
    unprojection (reference ``depthImgToPosCam_Batched``,
    visualize_utils.py:115-123)."""
    h, w = depth.shape
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32), indexing="xy")
    x = depth * (xs - princpt[0]) / focal[0]
    y = depth * (ys - princpt[1]) / focal[1]
    return np.stack([x, y, depth], axis=0)


def normals_from_cam_points(p: np.ndarray) -> np.ndarray:
    """(3,H,W) positions → (3,H,W) unit normals from central differences
    (reference ``computeNormalsFromPosCam_Batched``,
    visualize_utils.py:127-137): replicate-pad, cross(d/dy, d/dx),
    negated unit-normalized."""
    pp = np.pad(p, ((0, 0), (1, 1), (1, 1)), mode="edge")
    d0 = pp[:, 2:, 1:-1] - pp[:, :-2, 1:-1]
    d1 = pp[:, 1:-1, 2:] - pp[:, 1:-1, :-2]
    n = np.cross(d0, d1, axis=0)
    norm = np.linalg.norm(n, axis=0, keepdims=True) + 1e-5
    norm = np.where(norm < 1e-5, 1.0, norm)
    return -n / norm


def visualize_normal(depth: np.ndarray, focal: Tuple[float, float],
                     princpt: Tuple[float, float],
                     label: Optional[str] = "normal_p") -> np.ndarray:
    """Depth map → captioned normal visualization image (reference
    ``visualize_normal``, visualize_utils.py:139-152; its BGR channel
    flip is a legacy-format artifact and is reproduced)."""
    pos = depth_to_cam_points(np.asarray(depth, np.float32), focal, princpt)
    normal = 0.5 * (normals_from_cam_points(pos) + 1.0)
    return to_image(normal[::-1], label=label)
