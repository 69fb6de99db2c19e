"""A configuration's scene, made from the run's seed.

Everything here is an input that the program and the reference both
receive: camera poses (host numbers), the anchors (a PLY file that both
read), and the targets (device tensors: smooth images, per-view object
masks, a positive affine "monocular" depth, and the reference view's own
"inpainted" image and depth).  The scene's geometry (the cameras' jitter,
the anchors' positions, scales and offsets) is drawn from the
configuration's :func:`run_seed`, so every run asks the same work of the
card; the values (the anchors' features, the targets) from the run's
``--seed``.  The anchors and targets are drawn on the device from
``torch.Generator`` streams, in a few large calls.

Rigs: ``forward`` (a forward-facing capture as in SPIN-NeRF and LLFF:
cameras on a small jittered grid looking down +z at a slab of anchors,
the object a dense blob at the slab's centre) and ``orbit`` (a 360°
capture as in Mip-NeRF 360: cameras on a circle above the ground, looking
at the object at the origin, every ``test_every``-th pose held out).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch


def run_seed(cfg: Dict) -> int:
    """The seed the program's own draws take (``RunConfig.seed``: the
    decoders' initialisation, the view order, the loop's boxes, the token
    and densification draws), fixed by the configuration so that every
    run's work is the same: the decoders' random biases set the whole
    scene's opacity and scale, and with them the instances a view emits,
    the capacity tier and the densification's growth (runs of the same
    scene drawn with other decoder seeds differed by 15% in rate).  It
    also draws the scene's geometry, for the same reason: anchors drawn
    anew near a camera moved the instance tier, and the rate 20%, from
    seed to seed."""
    return int(cfg["run_seed"])


class Pose(NamedTuple):
    R: np.ndarray      # (3,3) camera→world rotation
    T: np.ndarray      # (3,) world→camera translation
    center: np.ndarray


class Scene(NamedTuple):
    width: int
    height: int
    fov_x: float
    fov_y: float
    train: List[Pose]
    test: List[Pose]
    spiral: List[Pose]
    object_center: np.ndarray
    object_radius: float


def _look_at(eye, target, up=(0.0, 1.0, 0.0)) -> Pose:
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    # camera axes: x right, y down, z forward (the COLMAP convention)
    R = np.stack([right, down, fwd], 1)
    return Pose(R=R, T=-R.T @ eye, center=eye)


def _seed_rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), salt]))


def cameras(cfg: Dict) -> Scene:
    s = cfg["scene"]
    w, h = s["width"], s["height"]
    fov_x = s["fov_x"]
    fov_y = 2 * math.atan(math.tan(fov_x / 2) * h / w)
    rng = _seed_rng(run_seed(cfg), 1)
    obj = np.asarray(s["object_center"], np.float64)
    poses = []
    if s["rig"] == "forward":
        n = s["n_views"]
        cols = int(math.ceil(math.sqrt(n * 16 / 9)))
        for i in range(n):
            gx = (i % cols) / max(cols - 1, 1) - 0.5
            gy = (i // cols) / max(math.ceil(n / cols) - 1, 1) - 0.5
            eye = np.array([gx * s["baseline"][0], gy * s["baseline"][1],
                            0.0]) + rng.normal(0, 0.01, 3)
            look = obj + rng.normal(0, 0.05, 3)
            poses.append(_look_at(eye, look))
        test_idx = set(range(s["n_test"]))       # index < n_test is test
    else:
        n = s["n_views"]
        for i in range(n):
            th = 2 * math.pi * i / n
            r = s["orbit_radius"] * (1 + rng.normal(0, 0.02))
            eye = np.array([r * math.sin(th),
                            s["orbit_height"] + rng.normal(0, 0.05),
                            -r * math.cos(th)])
            poses.append(_look_at(eye, obj + rng.normal(0, 0.05, 3),
                                  up=(0.0, -1.0, 0.0)))
        test_idx = set(range(0, n, s["test_every"]))
    train = [p for i, p in enumerate(poses) if i not in test_idx]
    test = [p for i, p in enumerate(poses) if i in test_idx]
    return Scene(width=w, height=h, fov_x=fov_x, fov_y=fov_y, train=train,
                 test=test, spiral=spiral(s, poses, obj),
                 object_center=obj, object_radius=s["object_radius"])


def spiral(s: Dict, poses: List[Pose], obj: np.ndarray) -> List[Pose]:
    """The render path: LLFF's spiral about the mean pose (two turns with a
    depth wobble) for a forward rig, an elliptical orbit with a height
    wobble for a 360° rig; ``spiral_frames`` poses."""
    n = s["spiral_frames"]
    out = []
    if s["rig"] == "forward":
        centers = np.stack([p.center for p in poses])
        c0 = centers.mean(0)
        rad = np.percentile(np.abs(centers - c0), 90, 0) + 1e-3
        for th in np.linspace(0, 4 * math.pi, n, endpoint=False):
            eye = c0 + np.array([math.cos(th) * rad[0],
                                 -math.sin(th) * rad[1],
                                 -math.sin(th / 2) * 0.05])
            out.append(_look_at(eye, obj))
    else:
        r = s["orbit_radius"]
        for th in np.linspace(0, 2 * math.pi, n, endpoint=False):
            eye = np.array([0.9 * r * math.sin(th),
                            s["orbit_height"] * (1 + 0.2 * math.sin(2 * th)),
                            -1.05 * r * math.cos(th)])
            out.append(_look_at(eye, obj, up=(0.0, -1.0, 0.0)))
    return out


def anchor_columns(cfg: Dict, seed: int, device) -> Dict[str, np.ndarray]:
    """The scene's anchors as PLY columns, drawn on the device: from the
    configuration's :func:`run_seed`, positions (a share in the object's
    blob, the rest in the scene's volume), a log-scale from the mean
    spacing with a log-normal spread and offsets N(0, 0.5) of the extent;
    from ``seed``, features N(0, 0.3); identity rotations, and opacity and
    uncertainty logits at σ⁻¹(0.1)."""
    s, m = cfg["scene"], cfg["model"]
    n, k, F = s["n_anchors"], m["n_offsets"], m["feat_dim"]
    g = torch.Generator(device=device).manual_seed(run_seed(cfg))
    n_obj = int(n * s["object_share"])
    lo = torch.tensor(s["volume_min"], device=device)
    hi = torch.tensor(s["volume_max"], device=device)
    u = torch.rand((n - n_obj, 3), generator=g, device=device)
    rest = lo + u * (hi - lo)
    obj = torch.tensor(s["object_center"], device=device) + \
        s["object_radius"] * 0.5 * torch.randn(
            (n_obj, 3), generator=g, device=device)
    xyz = torch.cat([obj, rest])
    vol = float(torch.prod(hi - lo))
    spacing = (vol / n) ** (1 / 3)
    logs = math.log(spacing) + 0.3 * torch.randn((n, 1), generator=g,
                                                 device=device)
    cols = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    off = 0.5 * torch.randn((n, 3 * k), generator=g, device=device)
    feat = 0.3 * torch.randn(
        (n, F), generator=torch.Generator(device=device).manual_seed(
            int(seed)), device=device)
    for i in range(3 * k):
        cols[f"f_offset_{i}"] = off[:, i]
    for i in range(F):
        cols[f"f_anchor_feat_{i}"] = feat[:, i]
    logit = math.log(0.1 / 0.9)
    cols["opacity"] = torch.full((n,), logit, device=device)
    cols["uncertainty"] = torch.full((n,), logit, device=device)
    for i in range(6):
        cols[f"scale_{i}"] = logs[:, 0]
    for i, v in enumerate((1.0, 0.0, 0.0, 0.0)):
        cols[f"rot_{i}"] = torch.full((n,), v, device=device)
    return {c: t.cpu().numpy() for c, t in cols.items()}


def _smooth(gen, n, h, w, lo, hi, device, terms=4):
    """(n, h, w) smooth fields in [lo, hi]: sums of ``terms`` low-frequency
    plane waves with random directions and phases."""
    y = torch.linspace(0, 1, h, device=device)[:, None]
    x = torch.linspace(0, 1, w, device=device)[None, :]
    f = 1 + 4 * torch.rand((n, terms, 2), generator=gen, device=device)
    ph = 2 * math.pi * torch.rand((n, terms), generator=gen, device=device)
    out = torch.zeros((n, h, w), device=device)
    for t in range(terms):
        out += torch.sin(2 * math.pi * (f[:, t, 0, None, None] * x
                                        + f[:, t, 1, None, None] * y)
                         + ph[:, t, None, None])
    return lo + (hi - lo) * (0.5 + out / (2 * terms))


def object_box(pose: Pose, scene: Scene):
    """(y0, y1, x0, x1) pixels of the object's bounding sphere seen from
    ``pose``: the view's object mask."""
    w, h = scene.width, scene.height
    fx = w / (2 * math.tan(scene.fov_x / 2))
    fy = h / (2 * math.tan(scene.fov_y / 2))
    c = pose.R.T @ scene.object_center + pose.T
    z = max(c[2], 1e-3)
    cx, cy = fx * c[0] / z + w / 2, fy * c[1] / z + h / 2
    rx, ry = fx * scene.object_radius / z, fy * scene.object_radius / z
    return (int(np.clip(cy - ry, 0, h - 1)), int(np.clip(cy + ry, 1, h)),
            int(np.clip(cx - rx, 0, w - 1)), int(np.clip(cx + rx, 1, w)))


def targets(scene: Scene, seed: int, device, chunk: int = 16):
    """Per training view (image (3,H,W), mask (1,H,W), mono depth (1,H,W)),
    and the reference view's (image, depth)."""
    g = torch.Generator(device=device).manual_seed(int(seed) + 7)
    h, w = scene.height, scene.width
    out = []
    n = len(scene.train)
    for s0 in range(0, n, chunk):
        k = min(chunk, n - s0)
        img = _smooth(g, 3 * k, h, w, 0.05, 0.95, device).reshape(k, 3, h, w)
        mono = _smooth(g, k, h, w, 0.2, 1.0, device, terms=2)
        for i in range(k):
            y0, y1, x0, x1 = object_box(scene.train[s0 + i], scene)
            mask = torch.zeros((1, h, w), device=device)
            mask[:, y0:y1, x0:x1] = 1.0
            out.append((img[i].contiguous(), mask, mono[i][None].clone()))
    ref_img = _smooth(g, 3, h, w, 0.05, 0.95, device)
    ref_depth = _smooth(g, 1, h, w, 0.2, 1.0, device, terms=2)
    return out, ref_img, ref_depth
