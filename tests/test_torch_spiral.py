"""The spiral split and the host-side pieces around it, on the CPU:
``normals_from_depth`` (torch, on the depth's device) against the JAX
package's numpy function on a flat plane, a tilted plane and a
random-depth scene — per pixel within 2e-3 except at most 0.5% of the
pixels, where a det < 1e-5 reset or a rejection at |Δz/z| = 0.15 flips
under sums in another order; the spiral ``render_set``'s files, with
the PNG-in-AVI video (cv2 and imageio hidden, as on the card's machine)
decoded by imageio to the renders bit for bit; ``write_video``'s order
(mp4, MJPEG AVI, PNG AVI); ``MetricsLogger``'s image grids and wandb
mirror; the code snapshot's listing; ``utils/visualize.py`` and the
inferno colormap against JAX's, bit-equal."""
import json
import os
import sys
import types
import zipfile

import numpy as np
import pytest
import torch

from gscream_tpu.train import render_sets as jax_rs
from gscream_tpu.utils import visualize as jax_vis
from gscream_tpu_torch.train import render_sets as port_rs
from gscream_tpu_torch.utils import video as port_video
from gscream_tpu_torch.utils import visualize as port_vis

NORMAL_ATOL = 2e-3
NORMAL_FLIP_FRACTION = 5e-3
H, W = 48, 64


def _K(f=50.0):
    return np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])


def _c2w():
    w2c = np.array([[1, 0, 0, 0.1], [0, 0.9, -0.1, 0.2], [0, 0.1, 0.9, 3.0],
                    [0, 0, 0, 1]], np.float32)
    return np.linalg.inv(w2c)


def _depths():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    return {"flat": np.full((H, W), 2.0, np.float32),
            "tilted": (1.5 + 0.01 * xx + 0.005 * yy).astype(np.float32),
            "random": rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)}


@pytest.mark.parametrize("case", ["flat", "tilted", "random"])
def test_normals_match_jax(case):
    depth, c2w, K = _depths()[case], _c2w(), _K()
    ref = jax_rs.normals_from_depth(depth, c2w, K)
    got = port_rs.normals_from_depth(torch.from_numpy(depth), c2w, K)
    assert got.shape == (3, H, W) and got.dtype == torch.float32
    err = np.abs(got.numpy() - ref).max(0)
    assert (err > NORMAL_ATOL).mean() <= NORMAL_FLIP_FRACTION, err.max()
    if case != "random":
        # a plane's normals are unit vectors, the same at every pixel
        n = got.numpy().reshape(3, -1)
        np.testing.assert_allclose(np.linalg.norm(n, axis=0), 1, atol=1e-5)


def test_inferno_and_visualize_match_jax():
    d = _depths()["random"]
    np.testing.assert_array_equal(port_rs._inferno(d), jax_rs._inferno(d))
    x = np.random.default_rng(1).uniform(-1, 2, (1, H, W)).astype(np.float32)
    for fn in ("to_rgb8", "to_jet"):
        np.testing.assert_array_equal(getattr(port_vis, fn)(x[0]),
                                      getattr(jax_vis, fn)(x[0]))
    for kw in ({}, {"mode": "jet"}, {"mask": x[0] > 0}, {"label": "abc"}):
        np.testing.assert_array_equal(port_vis.to_image(x, **kw),
                                      jax_vis.to_image(x, **kw))
    args = (d, (50.0, 50.0), (W / 2, H / 2))
    np.testing.assert_array_equal(port_vis.depth_to_cam_points(*args),
                                  jax_vis.depth_to_cam_points(*args))
    np.testing.assert_array_equal(
        port_vis.normals_from_cam_points(jax_vis.depth_to_cam_points(*args)),
        jax_vis.normals_from_cam_points(jax_vis.depth_to_cam_points(*args)))
    np.testing.assert_array_equal(port_vis.visualize_normal(*args),
                                  jax_vis.visualize_normal(*args))
    img = np.zeros((H, W, 3), np.uint8)
    for align in ("top", "bottom"):
        np.testing.assert_array_equal(
            port_vis.add_label_centered(img, "x", alignment=align),
            jax_vis.add_label_centered(img, "x", alignment=align))


def _hide(monkeypatch, *mods):
    for m in mods:
        monkeypatch.setitem(sys.modules, m, None)


def test_write_video_order(tmp_path, monkeypatch):
    """cv2's mp4 first, then MJPEG frames through imageio, then PNG
    frames: the AVI's fourcc names the frames' format."""
    frames = [np.random.default_rng(i).uniform(0, 1, (16, 24, 3))
              for i in range(3)]
    if "cv2" in sys.modules or _imports("cv2"):
        assert port_video.write_video(str(tmp_path / "a"), frames) \
            .endswith(".mp4")
    _hide(monkeypatch, "cv2")
    if _imports("imageio.v2"):
        p = port_video.write_video(str(tmp_path / "b"), frames)
        assert p.endswith(".avi") and b"MJPG" in open(p, "rb").read(256)
        assert len(port_video.avi_frames(p)) == 3
    _hide(monkeypatch, "imageio", "imageio.v2")
    p = port_video.write_video(str(tmp_path / "c"), frames)
    assert p.endswith(".avi") and b"MPNG" in open(p, "rb").read(256)
    assert port_video.write_video(str(tmp_path / "d"), []) == ""


def _imports(name):
    try:
        __import__(name)
    except ImportError:
        return False
    return True


@pytest.fixture(scope="module")
def spiral_run(tmp_path_factory):
    """The spiral split of a small random scaffold at 64×48 over six
    ``get_spiral`` poses, with cv2, imageio and matplotlib hidden."""
    from gscream_tpu_torch.cameras import make_camera_from_c2w
    from gscream_tpu_torch.data.spiral import get_spiral
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig, \
        init_scaffold
    out = str(tmp_path_factory.mktemp("spiral"))
    rng = np.random.default_rng(0)
    cfg = ScaffoldConfig(feat_dim=8, n_offsets=2, voxel_size=0.05,
                         capacity=512)
    st = init_scaffold(rng.normal(0, 0.4, (300, 3)).astype(np.float32), cfg,
                       torch.Generator().manual_seed(0), device="cpu")
    c2ws = []
    for th in (0.0, 0.3, 0.6, 0.9):
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
        c2w = np.eye(4)[:3]
        c2w[:, :3], c2w[:, 3] = R, R @ np.array([0, 0, -3.0])
        c2ws.append(c2w)
    poses = get_spiral(np.stack(c2ws), np.tile([[1.5, 4.5]], (4, 1)),
                       n_views=6)
    cams = [make_camera_from_c2w(p, 1.0, 0.75, W, H, device="cpu")
            for p in poses]
    saved = {m: sys.modules.get(m, "absent") for m in
             ("cv2", "imageio", "imageio.v2", "matplotlib", "matplotlib.cm")}
    try:
        for m in saved:
            sys.modules[m] = None
        res = port_rs.render_set(out, "spiral", cams, st, cfg,
                                 capacity=1 << 14)
    finally:
        for m, v in saved.items():
            if v == "absent":
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = v
    return out, res, cams


def test_spiral_render_set_files(spiral_run):
    out, res, cams = spiral_run
    base = os.path.join(out, "spiral")
    assert len(res["renders"]) == 6 and max(res["overflow_demand"]) <= 1 << 14
    assert min(float(r.max()) for r in res["renders"]) > 0.1   # not blank
    for sub in ("renders", "depth", "normal"):
        assert sorted(os.listdir(os.path.join(base, sub))) == \
            [f"{i:05d}.png" for i in range(6)], sub
    with open(os.path.join(base, "per_view_count.json")) as f:
        assert len(json.load(f)) == 6
    assert not os.path.exists(os.path.join(base, "video.mp4"))
    imageio = pytest.importorskip("imageio.v2")
    frames = port_video.avi_frames(os.path.join(base, "video.avi"))
    assert len(frames) == 6
    for raw, r in zip(frames, res["renders"]):
        u8 = (np.clip(r.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        assert np.array_equal(imageio.imread(raw), u8)
    from gscream_tpu_torch.utils.png import read_png
    depth_png = read_png(os.path.join(base, "depth", "00000.png"))
    assert depth_png.shape == (H, W, 3)
    # matplotlib hidden: the inferno map falls back to grey
    assert np.array_equal(depth_png[..., 0], depth_png[..., 1])


def test_metrics_logger_images_and_wandb(tmp_path, monkeypatch):
    calls = []
    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: calls.append(("init", kw["project"]))
    fake.log = lambda d, step=None: calls.append(("log", step, dict(d)))
    fake.finish = lambda: calls.append(("finish",))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    from gscream_tpu_torch.train.metrics_log import MetricsLogger
    m = MetricsLogger(str(tmp_path / "a"), tensorboard=False,
                      wandb_project="gscream")
    m.log(5, {"loss": 1.0})
    m.log_images(5, {"x": np.zeros((4, 4, 3))})      # no TensorBoard: no-op
    m.close()
    assert calls == [("init", "gscream"), ("log", 5, {"loss": 1.0}),
                     ("finish",)]
    assert not os.path.exists(tmp_path / "a" / "tb")
    pytest.importorskip("torch.utils.tensorboard")
    m = MetricsLogger(str(tmp_path / "b"))
    m.log_images(3, {"hwc": np.ones((4, 6, 3)), "chw": np.ones((3, 4, 6))})
    m.close()
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(tmp_path / "b" / "tb"))
    acc.Reload()
    assert sorted(acc.Tags()["images"]) == ["chw", "hwc"]
    ev = acc.Images("hwc")[0]
    assert (ev.step, ev.width, ev.height) == (3, 6, 4)


def test_code_snapshot_listing(tmp_path):
    from gscream_tpu_torch.utils.snapshot import save_runtime_code
    with zipfile.ZipFile(save_runtime_code(str(tmp_path))) as z:
        names = z.namelist()
    assert {"train_torch.py", "evaluate_torch.py", "GIT_HEAD",
            "gscream_tpu_torch/csrc/blend.cuh",
            "gscream_tpu_torch/csrc/rasterize_fwd.cu",
            "gscream_tpu_torch/utils/snapshot.py"} <= set(names)
    for skipped in ("gscream_tpu_torch/build/", "parent_tree/",
                    "smoke_out/", ".git/"):
        assert not any(n.startswith(skipped) for n in names), skipped
    assert all(n.endswith((".py", ".md", ".cu", ".cuh")) or n == "GIT_HEAD"
               for n in names)
