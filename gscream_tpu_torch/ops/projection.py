"""Gaussian preprocess: world-space gaussians → screen-space splats
(counterpart of ``gscream_tpu/ops/projection.py``).

Semantics of the reference CUDA preprocess (``forward.cu:157-267``):

* near-plane cull at view z <= 0.2       (auxiliary.h:139-164)
* perspective divide by ``w + 1e-7``     (auxiliary.h:146-148)
* quat→rotation with the reference's (r,x,y,z) layout, unnormalized
  (forward.cu:129-141)
* EWA Jacobian with 1.3·tan_fov frustum clamp (forward.cu:84-90)
* +0.3 low-pass dilation of the 2D covariance diagonal (forward.cu:112-113)
* radius = ceil(3·sqrt(max eigenvalue)), discriminant clamp 0.1
  (forward.cu:229-236)
* depth = view-space z (forward.cu:261)

plus the JAX package's tight iso rects (``t_iso``) when ``opacity`` is
given and ``GSCREAM_TIGHT_CULL`` is not ``0`` (read per call, as the JAX
package's :331 reads it).  :func:`preprocess` keeps the JAX package's column-unrolled
expression order, operation for operation, so its float32 results track
XLA's.  Culled gaussians carry ``radius == 0``.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

# Blend/prune constants of the reference rasterizer (forward.cu:524-541).
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_STOP = 1e-4
NEAR_Z = 0.2
COV2D_DILATION = 0.3
EIG_CLAMP = 0.1


def clamp_alpha(x: torch.Tensor) -> torch.Tensor:
    """min(x, 0.99) in value, identity in gradient (projection.py:42-51):
    the reference backward ignores the clamp (backward.cu:585-604), and the
    oracle rasterizer keeps that straight-through gradient."""
    return x + (torch.clamp_max(x, ALPHA_MAX) - x).detach()


class Splats(NamedTuple):
    """Screen-space splats: the rasterizer's per-gaussian inputs."""
    mean2d: torch.Tensor    # (N,2) f32 pixel coordinates of the center
    conic: torch.Tensor     # (N,3) f32 inverse 2D covariance (a,b,c)
    depth: torch.Tensor     # (N,)  f32 view-space z
    radius: torch.Tensor    # (N,)  int32 pixel radius, 0 => culled
    cov2d: torch.Tensor     # (N,3) f32 dilated 2D covariance (a,b,c)
    rect_min: torch.Tensor  # (N,2) int32 inclusive tile rect start (x,y)
    rect_max: torch.Tensor  # (N,2) int32 exclusive tile rect end (x,y)
    t_iso: Optional[torch.Tensor] = None
    # (N,) f32 iso threshold t = ln(255·op)+guard of the α ≥ 1/255 level
    # set (> 0 where tight emission applies, 0 ⇒ emits nothing); None ⇒
    # tight culling off


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N,4) quaternion (r,x,y,z) → (N,3,3) rotation, reference layout
    (forward.cu:129-141; the quaternion is used as given)."""
    r, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def build_cov3d(scale: torch.Tensor, rot: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """(N,3) scales + (N,4) quats → (N,6) upper-tri Σ = R S² Rᵀ
    (forward.cu:120-154), as [Σ00, Σ01, Σ02, Σ11, Σ12, Σ22]."""
    R = quat_to_rotmat(rot)
    S = scale_modifier * scale
    M = R * S[:, None, :]
    sigma = torch.einsum('nij,nkj->nik', M, M)
    return torch.stack([
        sigma[:, 0, 0], sigma[:, 0, 1], sigma[:, 0, 2],
        sigma[:, 1, 1], sigma[:, 1, 2], sigma[:, 2, 2],
    ], dim=-1)


def project_points(means3d: torch.Tensor, w2c: torch.Tensor,
                   full_proj: torch.Tensor):
    """(N,3) world points → (p_view (N,3), p_ndc (N,3)) with the
    reference's ``w + 1e-7`` divide (auxiliary.h:57-76)."""
    ones = torch.ones_like(means3d[:, :1])
    hom = torch.cat([means3d, ones], dim=-1)
    p_view = hom @ w2c[:3].T
    p_clip = hom @ full_proj.T
    p_w = 1.0 / (p_clip[:, 3:4] + 1e-7)
    return p_view, p_clip[:, :3] * p_w


def _floor_div(x, d: int):
    return torch.floor(x / d)


def _ewa_columns(tx, ty, tz, cov, w2c, focal_x, focal_y, tan_fovx,
                 tan_fovy):
    """(a, b, c) of the dilated 2D covariance from view-space columns
    and the six Σ columns, operation for operation as :func:`preprocess`
    has always taken them (M = W Σ Wᵀ in the JAX column sum order)."""
    c00, c01, c02, c11, c12, c22 = cov
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tx = torch.minimum(torch.maximum(tx / tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(ty / tz, -limy), limy) * tz

    # M = W Σ Wᵀ with W = w2c[:3,:3] scalars, in the JAX sum order
    W = w2c[:3, :3]
    cv = ((c00, c01, c02), (c01, c11, c12), (c02, c12, c22))
    Y = [[sum(W[i, j] * cv[j][k] for j in range(3)) for k in range(3)]
         for i in range(3)]

    def Ment(i, l):
        return sum(Y[i][k] * W[l, k] for k in range(3))
    m00, m01, m02 = Ment(0, 0), Ment(0, 1), Ment(0, 2)
    m11, m12, m22 = Ment(1, 1), Ment(1, 2), Ment(2, 2)

    inv_z = 1.0 / tz
    u = focal_x * inv_z
    v = focal_y * inv_z
    s = -(focal_x * tx) * inv_z * inv_z
    t = -(focal_y * ty) * inv_z * inv_z
    a = u * u * m00 + 2.0 * u * s * m02 + s * s * m22 + COV2D_DILATION
    b = u * v * m01 + u * t * m02 + v * s * m12 + s * t * m22
    c = v * v * m11 + 2.0 * v * t * m12 + t * t * m22 + COV2D_DILATION
    return a, b, c


def ewa_cov2d(means3d: torch.Tensor, p_view: torch.Tensor,
              cov3d: torch.Tensor, w2c: torch.Tensor, focal_x, focal_y,
              tan_fovx, tan_fovy) -> torch.Tensor:
    """EWA splatting's 2D covariance, (N,3) = (a, b, c) upper triangle
    with the +0.3 dilation (JAX ``ewa_cov2d``, projection.py:122;
    ``computeCov2D``, forward.cu:76-115): the view-space point clamped to
    the 1.3·tan_fov frustum, cov2D = J W Σ Wᵀ Jᵀ + 0.3·I.  ``cov3d`` is
    (N,6) [Σ00, Σ01, Σ02, Σ11, Σ12, Σ22]; ``means3d`` is unused, as in
    JAX."""
    del means3d
    a, b, c = _ewa_columns(p_view[:, 0], p_view[:, 1], p_view[:, 2],
                           tuple(cov3d[:, i] for i in range(6)), w2c,
                           focal_x, focal_y, tan_fovx, tan_fovy)
    return torch.stack([a, b, c], dim=-1)


def _rect_columns(mean_x, mean_y, r, grid_x: int, grid_y: int, tile_w: int,
                  tile_h: int):
    """getRect's (auxiliary.h:45-56) float bounds: x and y of the
    inclusive start and the exclusive end, clipped to the grid."""
    return (_floor_div(mean_x - r, tile_w).clamp(0, grid_x),
            _floor_div(mean_y - r, tile_h).clamp(0, grid_y),
            _floor_div(mean_x + r + tile_w - 1, tile_w).clamp(0, grid_x),
            _floor_div(mean_y + r + tile_h - 1, tile_h).clamp(0, grid_y))


def tile_rect(mean2d: torch.Tensor, radius: torch.Tensor, width: int,
              height: int, tile_w: int, tile_h: int):
    """Per-gaussian tile rectangle, as ``getRect`` (JAX ``tile_rect``,
    projection.py:161): int32 ``rect_min`` (N,2) inclusive and
    ``rect_max`` (N,2) exclusive, in (x, y) tile coordinates."""
    grid_x = -(-width // tile_w)
    grid_y = -(-height // tile_h)
    x0, y0, x1, y1 = _rect_columns(mean2d[:, 0], mean2d[:, 1],
                                   radius.to(mean2d.dtype), grid_x, grid_y,
                                   tile_w, tile_h)
    return (torch.stack([x0, y0], -1).to(torch.int32),
            torch.stack([x1, y1], -1).to(torch.int32))


def preprocess(means3d: torch.Tensor, scales: torch.Tensor,
               rots: torch.Tensor, w2c: torch.Tensor,
               full_proj: torch.Tensor, width: int, height: int,
               tan_fovx, tan_fovy, scale_modifier: float = 1.0,
               cov3d_precomp: Optional[torch.Tensor] = None,
               tile_w: int = 16, tile_h: int = 16,
               active_mask: Optional[torch.Tensor] = None,
               opacity: Optional[torch.Tensor] = None) -> Splats:
    """N world gaussians → screen splats with cull mask (JAX
    ``preprocess``, projection.py:181-377).

    ``radius`` stays the reference's 3σ value; with ``opacity`` the
    emission rect is tightened to the α ≥ 1/255 iso-ellipse's bounding
    box (intersected with the 3σ rect) and ``t_iso`` is returned, unless
    ``GSCREAM_TIGHT_CULL=0``: then the rects stay the 3σ ones and
    ``t_iso`` is ``None`` (full-rect emission downstream).
    """
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)

    px, py, pz = means3d[:, 0], means3d[:, 1], means3d[:, 2]

    def xform(m, x, y, z):
        return m[0] * x + m[1] * y + m[2] * z + m[3]

    tview_x = xform(w2c[0], px, py, pz)
    tview_y = xform(w2c[1], px, py, pz)
    depth = xform(w2c[2], px, py, pz)
    in_front = depth > NEAR_Z

    p_clip_x = xform(full_proj[0], px, py, pz)
    p_clip_y = xform(full_proj[1], px, py, pz)
    p_clip_w = xform(full_proj[3], px, py, pz)
    p_w = 1.0 / (p_clip_w + 1e-7)
    ndc_x = p_clip_x * p_w
    ndc_y = p_clip_y * p_w

    if cov3d_precomp is None:
        # cov3D = R S² Rᵀ, unrolled (computeCov3D, forward.cu:120-154)
        qr, qx, qy, qz = rots[:, 0], rots[:, 1], rots[:, 2], rots[:, 3]
        r00 = 1 - 2 * (qy * qy + qz * qz)
        r01 = 2 * (qx * qy - qr * qz)
        r02 = 2 * (qx * qz + qr * qy)
        r10 = 2 * (qx * qy + qr * qz)
        r11 = 1 - 2 * (qx * qx + qz * qz)
        r12 = 2 * (qy * qz - qr * qx)
        r20 = 2 * (qx * qz - qr * qy)
        r21 = 2 * (qy * qz + qr * qx)
        r22 = 1 - 2 * (qx * qx + qy * qy)
        s0 = scale_modifier * scales[:, 0]
        s1 = scale_modifier * scales[:, 1]
        s2 = scale_modifier * scales[:, 2]
        s0, s1, s2 = s0 * s0, s1 * s1, s2 * s2
        c00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
        c01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
        c02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
        c11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
        c12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
        c22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    else:
        c00, c01, c02 = (cov3d_precomp[:, 0], cov3d_precomp[:, 1],
                         cov3d_precomp[:, 2])
        c11, c12, c22 = (cov3d_precomp[:, 3], cov3d_precomp[:, 4],
                         cov3d_precomp[:, 5])

    # EWA cov2D (computeCov2D, forward.cu:76-115), columns throughout;
    # z≈0 guarded for culled points (masked out downstream)
    tz = torch.where(in_front, depth, torch.ones_like(depth))
    tx = torch.where(in_front, tview_x, torch.zeros_like(tview_x))
    ty = torch.where(in_front, tview_y, torch.zeros_like(tview_y))
    a, b, c = _ewa_columns(tx, ty, tz, (c00, c01, c02, c11, c12, c22),
                           w2c, focal_x, focal_y, tan_fovx, tan_fovy)
    det = a * c - b * b
    det_valid = det != 0.0
    inv_det = 1.0 / torch.where(det_valid, det, torch.ones_like(det))

    mid = 0.5 * (a + c)
    # forward.cu:233-235: eigenvalue discriminant clamped at 0.1
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, EIG_CLAMP))
    lam_max = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam_max, 0.0)))

    mean_x = ((ndc_x + 1.0) * width - 1.0) * 0.5
    mean_y = ((ndc_y + 1.0) * height - 1.0) * 0.5

    # visibility (and the returned radius) use the reference's 3σ square —
    # getRect (auxiliary.h:45-56) then the zero-area early-out
    grid_x = -(-width // tile_w)
    grid_y = -(-height // tile_h)
    radius_i = radius_f.to(torch.int32)
    r = radius_f
    ref_rmin_x, ref_rmin_y, ref_rmax_x, ref_rmax_y = _rect_columns(
        mean_x, mean_y, r, grid_x, grid_y, tile_w, tile_h)
    area = (ref_rmax_x - ref_rmin_x) * (ref_rmax_y - ref_rmin_y)
    visible = in_front & det_valid & (area > 0)
    if active_mask is not None:
        visible = visible & active_mask
    radius = torch.where(visible, radius_i, torch.zeros_like(radius_i))

    if opacity is not None and os.environ.get("GSCREAM_TIGHT_CULL") != "0":
        # tight rect: α(d) = op·exp(-½ dᵀΣ⁻¹d) ≥ 1/255  ⇔  dᵀΣ⁻¹d ≤ 2t,
        # t = ln(255·op) (+0.02 guard); bbox half-widths √(2t·Σxx),
        # √(2t·Σyy), covered as the continuous interval [m-h, m+h] and
        # intersected with the reference rect (projection.py:331-361)
        t_op = torch.log(255.0 * torch.clamp_min(
            opacity.detach(), 1e-12)) + 0.02
        t_pos = torch.clamp_min(t_op, 0.0)
        hx = torch.minimum(torch.sqrt(2.0 * t_pos * torch.clamp_min(a, 0.0)),
                           r)
        hy = torch.minimum(torch.sqrt(2.0 * t_pos * torch.clamp_min(c, 0.0)),
                           r)
        emit = visible & (t_op > 0.0)
        rmin_x = torch.maximum(_floor_div(mean_x - hx, tile_w), ref_rmin_x)
        rmin_y = torch.maximum(_floor_div(mean_y - hy, tile_h), ref_rmin_y)
        rmax_x = torch.minimum(_floor_div(mean_x + hx, tile_w) + 1.0,
                               ref_rmax_x)
        rmax_y = torch.minimum(_floor_div(mean_y + hy, tile_h) + 1.0,
                               ref_rmax_y)
        rmax_x = torch.maximum(rmax_x, rmin_x)
        rmax_y = torch.maximum(rmax_y, rmin_y)
        vzi = emit.to(torch.int32)
        t_iso = torch.where(emit, t_pos, torch.zeros_like(t_pos))
    else:
        rmin_x, rmin_y = ref_rmin_x, ref_rmin_y
        rmax_x, rmax_y = ref_rmax_x, ref_rmax_y
        vzi = visible.to(torch.int32)
        t_iso = None

    def irect(x, y):
        return torch.stack([x.to(torch.int32) * vzi, y.to(torch.int32) * vzi],
                           dim=-1)

    return Splats(
        mean2d=torch.stack([mean_x, mean_y], dim=-1),
        conic=torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1),
        depth=depth, radius=radius,
        cov2d=torch.stack([a, b, c], dim=-1),
        rect_min=irect(rmin_x, rmin_y),
        rect_max=irect(rmax_x, rmax_y),
        t_iso=t_iso)


def visible_filter(means3d, scales, rots, camera, scale_modifier=1.0):
    """Anchor visibility prefilter: the ``radius > 0`` mask (JAX
    projection.py:380; the reference's ``filter_preprocessCUDA``,
    forward.cu:272-346)."""
    s = preprocess(means3d, scales, rots, camera.w2c, camera.full_proj,
                   camera.width, camera.height, camera.tan_fovx,
                   camera.tan_fovy, scale_modifier)
    return s.radius > 0


def position2d_filter(means3d, scales, rots, camera, scale_modifier=1.0):
    """(visible mask, x pixels, y pixels) per anchor (JAX
    projection.py:392; the reference's ``position2D_filter``,
    forward.cu:353-433)."""
    s = preprocess(means3d, scales, rots, camera.w2c, camera.full_proj,
                   camera.width, camera.height, camera.tan_fovx,
                   camera.tan_fovy, scale_modifier)
    return s.radius > 0, s.mean2d[:, 0], s.mean2d[:, 1]
