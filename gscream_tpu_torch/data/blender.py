"""NeRF-synthetic (Blender) scene reader (counterpart of
``gscream_tpu/data/blender.py``).

The reference's ``readNerfSyntheticInfo`` / ``readCamerasFromTransforms``
(scene/dataset_readers.py:390-467): ``transforms_{train,test}.json``
camera-to-world matrices in OpenGL/Blender axes (Y up, Z back) flipped
to the COLMAP convention (Y down, Z forward), RGBA frames composited
over a white or black background, FoV-y derived from
``camera_angle_x``, and, since Blender scenes ship no COLMAP model, a
uniform random cloud in the canonical [-1.3, 1.3]³ when no PLY is given
(dataset_readers.py:451-456).  Images stay numpy on the host; the
cameras' tensors are placed on ``device``.  Frames are read with
imageio, imported where a frame is read.
"""
from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from ..cameras import make_camera
from ..device import resolve_device
from .dataset import SceneData, View, cameras_extent
from .ply import read_ply_xyz


def _focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * np.arctan(pixels / (2.0 * focal))


def _fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * np.tan(fov / 2.0))


def _read_split(path: str, transformsfile: str, white_background: bool,
                extension: str, load_images: bool, device) -> List[View]:
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    views = []
    for frame in contents["frames"]:
        img_path = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"], np.float64)
        # OpenGL/Blender camera axes (Y up, Z back) → COLMAP
        # (Y down, Z forward), dataset_readers.py:403-404
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])   # stored transposed, like the ref
        T = w2c[:3, 3]

        image = None
        w = h = None
        if load_images and os.path.exists(img_path):
            import imageio.v2 as imageio
            rgba = np.asarray(imageio.imread(img_path), np.float32) / 255.0
            if rgba.ndim == 2:
                rgba = rgba[:, :, None].repeat(3, 2)
            if rgba.shape[2] == 4:
                bg = 1.0 if white_background else 0.0
                a = rgba[:, :, 3:4]
                rgb = rgba[:, :, :3] * a + bg * (1.0 - a)
            else:
                rgb = rgba[:, :, :3]
            image = rgb.transpose(2, 0, 1)
            h, w = rgb.shape[:2]
        if w is None:
            w = int(contents.get("w", 800))
            h = int(contents.get("h", 800))
        fovy = _focal2fov(_fov2focal(fovx, w), h)
        cam = make_camera(R, T, fovx, fovy, w, h, device=device)
        views.append(View(camera=cam, image=image, mask=None, depth=None,
                          name=os.path.splitext(
                              os.path.basename(img_path))[0],
                          is_train="train" in transformsfile))
    return views


def load_blender_scene(path: str, white_background: bool = False,
                       extension: str = ".png", ply_path: str = "",
                       load_images: bool = True, eval_split: bool = True,
                       seed: int = 0, device="cuda") -> SceneData:
    """Read a NeRF-synthetic scene (transforms_train/test.json layout)."""
    dev = resolve_device(device)
    train_views = _read_split(path, "transforms_train.json",
                              white_background, extension, load_images, dev)
    test_views = _read_split(path, "transforms_test.json",
                             white_background, extension, load_images, dev) \
        if os.path.exists(os.path.join(path, "transforms_test.json")) \
        else []
    if not eval_split:                       # ref: train on everything
        train_views += test_views
        test_views = []

    if not ply_path:
        ply_path = os.path.join(path, "points3d.ply")
    if os.path.exists(ply_path):
        pts = read_ply_xyz(ply_path)
    else:
        # random init inside the canonical Blender bounds
        # (dataset_readers.py:451-456)
        rng = np.random.default_rng(seed)
        pts = (rng.random((10_000, 3)) * 2.6 - 1.3).astype(np.float32)

    w2cs = [v.camera.w2c.cpu().numpy() for v in train_views]
    cam0 = train_views[0].camera
    return SceneData(
        train_views=train_views, test_views=test_views, points=pts,
        cameras_extent=cameras_extent(w2cs),
        ref_name=train_views[0].name, spiral_c2ws=None,
        fov_x=2.0 * float(np.arctan(float(cam0.tan_fovx))),
        fov_y=2.0 * float(np.arctan(float(cam0.tan_fovy))),
        cx_ndc=0.0, cy_ndc=0.0,
        width=cam0.width, height=cam0.height)
