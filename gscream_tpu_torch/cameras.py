"""Camera model and projection matrices (PyTorch counterpart of
``gscream_tpu/cameras.py``).

Same conventions as the reference, so projected centers, depths and
covariances agree with the JAX package:

* world-to-view from COLMAP ``(R, T)`` — reference
  ``utils/graphics_utils.py:38-48`` (``getWorld2View2``);
* off-center perspective projection with the principal-point offsets as
  NDC matrix entries ``P[0,2]=cx, P[1,2]=cy`` — reference
  ``utils/graphics_utils.py:51-74``;
* znear=0.01, zfar=100 — reference ``scene/cameras.py:59-60``.

Matrices are built in float64 numpy, then cast to float32 (the JAX
package does the same, ``cameras.py:121-142``), and stored in math
convention (column vectors, ``p' = M @ p``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .device import resolve_device

ZNEAR = 0.01
ZFAR = 100.0


def fov2focal(fov: float, pixels: int) -> float:
    """Reference utils/graphics_utils.py:76-77."""
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: int) -> float:
    """Reference utils/graphics_utils.py:79-80."""
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, T: np.ndarray,
                  translate: Optional[np.ndarray] = None,
                  scale: float = 1.0) -> np.ndarray:
    """4x4 float32 world→camera matrix (``R`` camera-to-world rotation,
    ``T`` world→camera translation; reference ``getWorld2View2``)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = T
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else translate
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float, fov_x: float, fov_y: float,
                      cx_ndc: float = 0.0, cy_ndc: float = 0.0) -> np.ndarray:
    """Off-center perspective projection, math convention (p' = P @ p)."""
    tan_x = math.tan(fov_x / 2.0)
    tan_y = math.tan(fov_y / 2.0)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[0, 2] = cx_ndc
    P[1, 2] = cy_ndc
    P[2, 2] = (znear + zfar) / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


class Camera(NamedTuple):
    """A pinhole camera; tensor fields live on the render device."""
    w2c: torch.Tensor          # (4,4) world→camera
    full_proj: torch.Tensor    # (4,4) proj @ w2c : world→clip
    cam_center: torch.Tensor   # (3,) camera position in world space
    tan_fovx: torch.Tensor     # () float32
    tan_fovy: torch.Tensor     # () float32
    width: int
    height: int

    @property
    def focal_x(self) -> torch.Tensor:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> torch.Tensor:
        return self.height / (2.0 * self.tan_fovy)


def _camera(w2c, full, center, fov_x, fov_y, width, height, device):
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return Camera(w2c=t(w2c), full_proj=t(full), cam_center=t(center),
                  tan_fovx=t(math.tan(fov_x / 2.0)),
                  tan_fovy=t(math.tan(fov_y / 2.0)),
                  width=int(width), height=int(height))


def make_camera(R: np.ndarray, T: np.ndarray, fov_x: float, fov_y: float,
                width: int, height: int,
                cx_ndc: float = 0.0, cy_ndc: float = 0.0,
                znear: float = ZNEAR, zfar: float = ZFAR,
                translate: Optional[np.ndarray] = None,
                scale: float = 1.0, device="cuda") -> Camera:
    w2c = world_to_view(R, T, translate, scale)
    proj = projection_matrix(znear, zfar, fov_x, fov_y, cx_ndc, cy_ndc)
    full = (proj.astype(np.float64) @ w2c.astype(np.float64)).astype(np.float32)
    c2w = np.linalg.inv(w2c.astype(np.float64))
    center = c2w[:3, 3].astype(np.float32)
    return _camera(w2c, full, center, fov_x, fov_y, width, height, device)


def make_camera_from_c2w(c2w: np.ndarray, fov_x: float, fov_y: float,
                         width: int, height: int,
                         cx_ndc: float = 0.0, cy_ndc: float = 0.0,
                         device="cuda") -> Camera:
    """Camera from a 4x4 (or 3x4) camera-to-world matrix (reference
    ``Camera_spiral``, scene/cameras.py:72-133, inverts the c2w)."""
    c2w = np.asarray(c2w, dtype=np.float64)
    if c2w.shape == (3, 4):
        c2w = np.concatenate([c2w, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
    w2c = np.linalg.inv(c2w).astype(np.float32)
    proj = projection_matrix(ZNEAR, ZFAR, fov_x, fov_y, cx_ndc, cy_ndc)
    full = (proj.astype(np.float64) @ w2c.astype(np.float64)).astype(np.float32)
    return _camera(w2c, full, c2w[:3, 3].astype(np.float32), fov_x, fov_y,
                   width, height, device)


def ndc2pix(v, size: int):
    """NDC coordinate → pixel coordinate (reference auxiliary.h:40-43)."""
    return ((v + 1.0) * size - 1.0) * 0.5


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP quaternion (w,x,y,z) → rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → COLMAP quaternion (w,x,y,z), the eigenvector of
    the largest eigenvalue of the symmetric 4×4 of the matrix (reference
    scene/colmap_loader.py, rotmat2qvec), with w ≥ 0."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec
