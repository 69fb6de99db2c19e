"""EWA splatting: world gaussians → screen-space splats (the preprocess of
the 3D Gaussian Splatting rasterizer, ``cuda_rasterizer/forward.cu``
``preprocessCUDA`` and ``auxiliary.h``).

Near-plane cull at view z ≤ 0.2, perspective divide by ``w + 1e-7``, the
unnormalised (r, x, y, z) quaternion, the Jacobian with the 1.3·tan_fov
frustum clamp, +0.3 dilation of the 2D covariance, radius
``ceil(3·sqrt(λmax))`` with the eigenvalue discriminant clamped at 0.1,
and the tile rectangle of ``getRect``.  The expressions are written term
by term in one fixed order, so that float32 results stay within a few
ulps of any implementation that keeps the same order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEAR_Z = 0.2


class Splats(NamedTuple):
    mean2d: torch.Tensor   # (N,2) pixel coordinates
    conic: torch.Tensor    # (N,3) inverse 2D covariance (a, b, c)
    depth: torch.Tensor    # (N,) view-space z
    radius: torch.Tensor   # (N,) float, 0 where culled
    cov2d: torch.Tensor    # (N,3) dilated 2D covariance (a, b, c)


def camera_matrices(R, T, fov_x, fov_y, znear=0.01, zfar=100.0):
    """float64 numpy world→view and world→clip matrices from a camera's
    rotation ``R`` (camera→world) and translation ``T`` (world→camera),
    as GScream's ``getWorld2View2`` and ``getProjectionMatrix`` build
    them, cast to float32."""
    import math

    import numpy as np
    w2c = np.zeros((4, 4))
    w2c[:3, :3] = np.asarray(R).T
    w2c[:3, 3] = T
    w2c[3, 3] = 1.0
    w2c = w2c.astype(np.float32)
    tx, ty = math.tan(fov_x / 2), math.tan(fov_y / 2)
    P = np.zeros((4, 4), np.float32)
    P[0, 0], P[1, 1] = 1 / tx, 1 / ty
    P[2, 2] = (znear + zfar) / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    full = (P.astype(np.float64) @ w2c.astype(np.float64)).astype(np.float32)
    center = np.linalg.inv(w2c.astype(np.float64))[:3, 3].astype(np.float32)
    return w2c, full, center, tx, ty


def preprocess(xyz, scale, rot, w2c, full, width, height, tan_x, tan_y,
               active=None, tile=32) -> Splats:
    focal_x = width / (2.0 * tan_x)
    focal_y = height / (2.0 * tan_y)
    px, py, pz = xyz[:, 0], xyz[:, 1], xyz[:, 2]

    def xf(m, x, y, z):
        return m[0] * x + m[1] * y + m[2] * z + m[3]

    vx, vy, depth = xf(w2c[0], px, py, pz), xf(w2c[1], px, py, pz), \
        xf(w2c[2], px, py, pz)
    front = depth > NEAR_Z
    cw = 1.0 / (xf(full[3], px, py, pz) + 1e-7)
    ndc_x = xf(full[0], px, py, pz) * cw
    ndc_y = xf(full[1], px, py, pz) * cw

    qr, qx, qy, qz = rot[:, 0], rot[:, 1], rot[:, 2], rot[:, 3]
    r = ((1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qr * qz),
          2 * (qx * qz + qr * qy)),
         (2 * (qx * qy + qr * qz), 1 - 2 * (qx * qx + qz * qz),
          2 * (qy * qz - qr * qx)),
         (2 * (qx * qz - qr * qy), 2 * (qy * qz + qr * qx),
          1 - 2 * (qx * qx + qy * qy)))
    s = [scale[:, i] * scale[:, i] for i in range(3)]

    def sig(i, j):
        return r[i][0] * r[j][0] * s[0] + r[i][1] * r[j][1] * s[1] \
            + r[i][2] * r[j][2] * s[2]
    cov = ((sig(0, 0), sig(0, 1), sig(0, 2)),
           (sig(0, 1), sig(1, 1), sig(1, 2)),
           (sig(0, 2), sig(1, 2), sig(2, 2)))

    tz = torch.where(front, depth, torch.ones_like(depth))
    tx = torch.where(front, vx, torch.zeros_like(vx))
    ty = torch.where(front, vy, torch.zeros_like(vy))
    limx, limy = 1.3 * tan_x, 1.3 * tan_y
    tx = torch.minimum(torch.maximum(tx / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(ty / tz, -limy), limy) * tz
    W = w2c[:3, :3]
    Y = [[sum(W[i, j] * cov[j][k] for j in range(3)) for k in range(3)]
         for i in range(3)]

    def M(i, l_):
        return sum(Y[i][k] * W[l_, k] for k in range(3))
    m00, m01, m02, m11, m12, m22 = M(0, 0), M(0, 1), M(0, 2), M(1, 1), \
        M(1, 2), M(2, 2)
    inv_z = 1.0 / tz
    u, v = focal_x * inv_z, focal_y * inv_z
    sj = -(focal_x * tx) * inv_z * inv_z
    tj = -(focal_y * ty) * inv_z * inv_z
    a = u * u * m00 + 2.0 * u * sj * m02 + sj * sj * m22 + 0.3
    b = u * v * m01 + u * tj * m02 + v * sj * m12 + sj * tj * m22
    c = v * v * m11 + 2.0 * v * tj * m12 + tj * tj * m22 + 0.3
    det = a * c - b * b
    det_ok = det != 0.0
    inv_det = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 0.0)))
    mx = ((ndc_x + 1.0) * width - 1.0) * 0.5
    my = ((ndc_y + 1.0) * height - 1.0) * 0.5
    gx, gy = -(-width // tile), -(-height // tile)
    x0 = torch.floor((mx - radius) / tile).clamp(0, gx)
    y0 = torch.floor((my - radius) / tile).clamp(0, gy)
    x1 = torch.floor((mx + radius + tile - 1) / tile).clamp(0, gx)
    y1 = torch.floor((my + radius + tile - 1) / tile).clamp(0, gy)
    visible = front & det_ok & ((x1 - x0) * (y1 - y0) > 0)
    if active is not None:
        visible = visible & active
    return Splats(
        mean2d=torch.stack([mx, my], -1),
        conic=torch.stack([c * inv_det, -b * inv_det, a * inv_det], -1),
        depth=depth, radius=torch.where(visible, radius,
                                        torch.zeros_like(radius)),
        cov2d=torch.stack([a, b, c], -1))
