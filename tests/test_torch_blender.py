"""The port's NeRF-synthetic (Blender) reader against the JAX package's,
on the CPU, on a scene written as ``tests/test_blender.py`` writes one
(``transforms_{train,test}.json`` with camera-to-world matrices in
Blender axes, PNG frames) but with seeded random RGBA frames, so that
the compositing sees every alpha: cameras within 1e-6, images
bit-equal over black and over white, the random init cloud, the extent
and the fields of view equal."""
import json
import os

import numpy as np
import pytest
import torch

from gscream_tpu.data.blender import load_blender_scene as jax_load
from gscream_tpu_torch.data.blender import load_blender_scene as port_load

imageio = pytest.importorskip("imageio.v2")


def write_blender_scene(root, n_train=3, n_test=1, w=40, h=32, seed=0):
    """Seeded RGBA frames and cameras on a circle at radius 3 looking at
    the origin (COLMAP axes flipped to Blender's, as the reference's
    reader undoes)."""
    rng = np.random.default_rng(seed)
    for split, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            ang = 0.4 * i + (0.2 if split == "test" else 0.0)
            fwd = -np.array([np.sin(ang), 0.1, np.cos(ang)])
            fwd /= np.linalg.norm(fwd)
            right = np.cross([0, -1, 0], fwd)
            right /= np.linalg.norm(right)
            w2c = np.eye(4)
            w2c[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 0)
            w2c[:3, 3] = -w2c[:3, :3] @ (-3.0 * fwd)
            c2w = np.linalg.inv(w2c)
            c2w[:3, 1:3] *= -1
            rgba = rng.integers(0, 256, (h, w, 4), np.uint8)
            rgba[0, 0, 3] = 0                     # one transparent pixel
            imageio.imwrite(os.path.join(root, split, f"r_{i}.png"), rgba)
            frames.append({"file_path": f"{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.9, "frames": frames}, f)


@pytest.mark.parametrize("white", [False, True])
def test_blender_scene_matches_jax(tmp_path, white):
    write_blender_scene(str(tmp_path))
    got = port_load(str(tmp_path), white_background=white, device="cpu")
    ref = jax_load(str(tmp_path), white_background=white)
    assert len(got.train_views) == 3 and len(got.test_views) == 1
    for gv, rv in zip(got.train_views + got.test_views,
                      ref.train_views + ref.test_views):
        assert (gv.name, gv.is_train) == (rv.name, rv.is_train)
        assert gv.image.dtype == np.float32
        assert np.array_equal(gv.image, rv.image)
        gc, rc = gv.camera, rv.camera
        assert (gc.width, gc.height) == (rc.width, rc.height)
        for f in ("w2c", "full_proj", "cam_center", "tan_fovx", "tan_fovy"):
            np.testing.assert_allclose(getattr(gc, f).numpy(),
                                       np.asarray(getattr(rc, f)),
                                       rtol=0, atol=1e-6, err_msg=f)
    assert np.array_equal(got.points, ref.points)
    assert got.cameras_extent == pytest.approx(ref.cameras_extent, abs=1e-6)
    assert got.fov_x == pytest.approx(ref.fov_x, abs=1e-6)
    assert got.fov_y == pytest.approx(ref.fov_y, abs=1e-6)
    assert (got.width, got.height, got.ref_name) == \
        (ref.width, ref.height, ref.ref_name)
    # the transparent pixel takes the background
    assert np.all(got.train_views[0].image[:, 0, 0] == float(white))


def test_blender_train_on_everything(tmp_path):
    """``eval_split=False`` folds the test frames into the training split,
    as the reference does."""
    write_blender_scene(str(tmp_path))
    got = port_load(str(tmp_path), eval_split=False, device="cpu")
    assert len(got.train_views) == 4 and got.test_views == []
    assert isinstance(got.train_views[0].camera.w2c, torch.Tensor)
