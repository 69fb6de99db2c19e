"""The port's evaluation against the JAX package's, on the CPU: the
evaluation SSIM (``kornia_ssim_map``, ``my_ssim`` full and masked) to
1e-6 absolute, VGG-LPIPS (full, masked, identical images, no weights)
to rtol 2e-4 with seeded random weights in a per-test ``.npz`` (the JAX
package caches its weights by path), ``evaluate_pairs`` at those bounds
with the same keys (LPIPS null without weights), and ``write_results``,
``load_test_label_masks`` and ``evaluate_dir`` on the artifacts
``tests/test_evaluate_cli.py`` writes (masks bit-equal, scores at the
same bounds).  Images are 64×48, made with numpy from a seed."""
import json
import os

import numpy as np
import pytest
import torch

import evaluate as jax_eval_cli
from gscream_tpu.metrics import lpips as jax_lpips
from gscream_tpu.ops import ssim as jax_ssim
from gscream_tpu.train import evaluate as jax_evaluate
from gscream_tpu_torch.metrics import lpips as port_lpips
from gscream_tpu_torch.ops import ssim as port_ssim
from gscream_tpu_torch.train import evaluate as port_evaluate

H, W = 48, 64
SSIM_ATOL = 1e-6
LPIPS_RTOL = 2e-4
PSNR_ATOL = 1e-4


def _pair(seed, noise=0.08):
    """A smooth image and a noisy copy, (3,H,W) float32 in [0, 1]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W] / 16.0
    base = np.stack([0.5 + 0.4 * np.sin(xx + c) * np.cos(yy - c)
                     for c in range(3)]).astype(np.float32)
    other = np.clip(base + rng.normal(0, noise, base.shape), 0, 1)
    return base, other.astype(np.float32)


def _mask(shape=(1, H, W)):
    m = np.zeros(shape, np.float32)
    m[..., 12:36, 20:50] = 1.0
    return m


def _random_weights(path, seed=11):
    """The export format's keys with seeded random values
    (``tests/test_lpips_parity.py``'s draw)."""
    rng = np.random.default_rng(seed)
    out, cin = {}, 3
    for i, (cout, _) in enumerate(port_lpips._VGG_PLAN):
        out[f"conv{i}_w"] = rng.normal(
            0, 0.1 / np.sqrt(cin * 9), (cout, cin, 3, 3)).astype(np.float32)
        out[f"conv{i}_b"] = rng.normal(0, 0.05, (cout,)).astype(np.float32)
        cin = cout
    for j, tap in enumerate(port_lpips._TAP_AFTER):
        out[f"lin{j}_w"] = np.abs(rng.normal(
            0, 0.01, (port_lpips._VGG_PLAN[tap][0],))).astype(np.float32)
    np.savez(path, **out)


@pytest.fixture()
def weights(tmp_path, monkeypatch):
    p = tmp_path / "lpips_random.npz"
    _random_weights(p)
    monkeypatch.setenv("GSCREAM_LPIPS_WEIGHTS", str(p))
    return p


@pytest.fixture()
def no_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("GSCREAM_LPIPS_WEIGHTS", str(tmp_path / "absent.npz"))
    monkeypatch.setenv("HOME", str(tmp_path))     # no ~/.cache file either


@pytest.mark.parametrize("seed,noise", [(0, 0.08), (1, 0.4)])
def test_kornia_ssim_map_and_my_ssim_match_jax(seed, noise):
    a, b = _pair(seed, noise)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(
        port_ssim.kornia_ssim_map(ta, tb).numpy(),
        np.asarray(jax_ssim.kornia_ssim_map(a, b)), rtol=0, atol=SSIM_ATOL)
    got = float(port_ssim.my_ssim(ta, tb))
    assert got == pytest.approx(float(jax_ssim.my_ssim(a, b)), rel=0,
                                abs=SSIM_ATOL)
    for m in (_mask(), _mask((H, W))):
        got = float(port_ssim.my_ssim(ta, tb, torch.from_numpy(m)))
        ref = float(jax_ssim.my_ssim(a, b, m))
        assert got == pytest.approx(ref, rel=0, abs=SSIM_ATOL)


def test_training_ssim_keeps_zero_padding():
    """The evaluation's reflect padding is a separate mode: the training
    SSIM still matches JAX's zero-padded ``ssim``."""
    a, b = _pair(2)
    got = float(port_ssim.ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(float(jax_ssim.ssim(a, b)), rel=0, abs=1e-6)


def test_lpips_matches_jax(weights):
    a, b = _pair(3, 0.1)
    assert port_lpips.lpips_available()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = float(port_lpips.lpips(ta, tb))
    ref = float(jax_lpips.lpips(a, b))
    assert got > 0 and got == pytest.approx(ref, rel=LPIPS_RTOL)
    m = _mask((H, W))
    got = float(port_lpips.lpips(ta, tb, torch.from_numpy(m)))
    ref = float(jax_lpips.lpips(a, b, mask=m))
    assert got == pytest.approx(ref, rel=LPIPS_RTOL)
    assert float(port_lpips.lpips(ta, ta)) == pytest.approx(0.0, abs=1e-9)


def test_lpips_odd_sizes_match_jax(weights):
    """Odd sizes floor at every pool, as ``reduce_window`` VALID does."""
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 1, (3, 37, 53)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    m = np.zeros((37, 53), np.float32)
    m[5:30, 7:41] = 1
    for mask in (None, m):
        got = float(port_lpips.lpips(
            torch.from_numpy(a), torch.from_numpy(b),
            None if mask is None else torch.from_numpy(mask)))
        ref = float(jax_lpips.lpips(a, b, mask=mask))
        assert got == pytest.approx(ref, rel=LPIPS_RTOL)


def test_lpips_without_weights(no_weights):
    assert not port_lpips.lpips_available()
    with pytest.raises(FileNotFoundError):
        port_lpips.load_weights()


def _scenes(n=3):
    pairs = [_pair(10 + i, 0.05 * (i + 1)) for i in range(n)]
    gts = [g for g, _ in pairs]
    renders = [r for _, r in pairs]
    masks = [_mask(), None, _mask()][:n]
    return renders, gts, masks


def _same_results(got, ref):
    assert set(got["summary"]) == set(ref["summary"])
    assert got["per_view"].keys() == ref["per_view"].keys()
    for name, row in ref["per_view"].items():
        assert set(got["per_view"][name]) == set(row), name
        for k, v in row.items():
            g = got["per_view"][name][k]
            if k.startswith("LPIPS"):
                assert g == pytest.approx(v, rel=LPIPS_RTOL), (name, k)
            else:
                tol = PSNR_ATOL if k.startswith("PSNR") else SSIM_ATOL
                assert g == pytest.approx(v, rel=0, abs=tol), (name, k)
    for k, v in ref["summary"].items():
        if v is None:
            assert got["summary"][k] is None, k


def test_evaluate_pairs_matches_jax(weights):
    renders, gts, masks = _scenes()
    got = port_evaluate.evaluate_pairs(renders, gts, masks, device="cpu")
    ref = jax_evaluate.evaluate_pairs(renders, gts, masks)
    _same_results(got, ref)
    assert got["summary"]["LPIPS"] > 0
    assert set(got["per_view"]["00001"]) == {"PSNR", "SSIM", "LPIPS"}


def test_evaluate_pairs_without_weights(no_weights, tmp_path):
    renders, gts, masks = _scenes()
    names = ["a.png", "b.png", "c.png"]
    got = port_evaluate.evaluate_pairs(renders, gts, masks, names=names,
                                       device="cpu")
    ref = jax_evaluate.evaluate_pairs(renders, gts, masks, names=names)
    _same_results(got, ref)
    assert got["summary"]["LPIPS"] is None
    assert not any("LPIPS" in k for r in got["per_view"].values()
                   for k in r)
    port_evaluate.write_results(str(tmp_path / "port"), got)
    jax_evaluate.write_results(str(tmp_path / "jax"), ref)
    for f in ("results.json", "per_view.json"):
        with open(tmp_path / "port" / f) as a, open(tmp_path / "jax" / f) as b:
            pa, ja = json.load(a), json.load(b)
        assert list(pa) == list(ja) == ["ours"]
        assert sorted(pa["ours"]) == sorted(ja["ours"])


def test_evaluate_pairs_wants_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    renders, gts, masks = _scenes(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_evaluate.evaluate_pairs(renders, gts, masks)


# the disk artifacts of tests/test_evaluate_cli.py: renders and gts as
# 8-bit PNGs, 1-indexed test_label masks at twice the render size

@pytest.fixture()
def artifacts(tmp_path):
    imageio = pytest.importorskip("imageio.v2")
    rng = np.random.default_rng(0)
    model, src = tmp_path / "model", tmp_path / "scene"
    h, w = 32, 48

    def write(path, chw):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        imageio.imwrite(path, (np.clip(chw.transpose(1, 2, 0), 0, 1)
                               * 255).astype(np.uint8))
    for i in range(3):
        gt = rng.uniform(0.2, 0.8, (3, h, w)).astype(np.float32)
        render = np.clip(gt + rng.normal(0, 0.03, gt.shape), 0, 1) \
            .astype(np.float32)
        write(str(model / "test" / "renders" / f"{i:05d}.png"), render)
        write(str(model / "test" / "gt" / f"{i:05d}.png"), gt)
        m = np.zeros((2 * h, 2 * w), np.float32)
        m[20:44, 30:70] = 1.0
        os.makedirs(src / "images_4" / "test_label", exist_ok=True)
        imageio.imwrite(
            str(src / "images_4" / "test_label" / ("out_%05d.png" % (1 + i))),
            (m * 255).astype(np.uint8))
    return str(model), str(src), (h, w)


def test_load_test_label_masks_match(artifacts):
    model, src, (h, w) = artifacts
    got = port_evaluate.load_test_label_masks(src, 3, (w, h))
    ref = jax_eval_cli.load_test_label_masks(src, 3, (w, h))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.shape == (1, h, w) and np.array_equal(g, r)
    assert port_evaluate.load_test_label_masks(model, 3, (w, h)) is None


def test_evaluate_dir_matches_jax(artifacts, no_weights):
    model, src, _ = artifacts
    d = os.path.join(model, "test")
    assert port_evaluate.find_method_dirs(model, "test") == \
        jax_eval_cli._find_method_dirs(model, "test") == [d]
    got = port_evaluate.evaluate_dir(d, source_path=src, device="cpu")
    with open(os.path.join(d, "per_view.json")) as f:
        written = json.load(f)["ours"]
    ref = jax_eval_cli.evaluate_dir(d, source_path=src)
    _same_results(got, ref)
    assert written == got["per_view"] and "PSNR_masked" in got["summary"]


def test_read_image_without_imageio(tmp_path, monkeypatch):
    """Where imageio does not import (the card's machine), the port's own
    PNG reader reads the port's PNGs to the pixels imageio reads."""
    import sys
    from gscream_tpu_torch.utils.png import write_png
    rgb = np.random.default_rng(5).integers(0, 256, (H, W, 3), np.uint8)
    p = str(tmp_path / "frame.png")
    write_png(p, rgb)
    ref = port_evaluate._read_image(p)
    assert np.array_equal(ref, rgb.transpose(2, 0, 1) / np.float32(255))
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    assert np.array_equal(port_evaluate._read_image(p), ref)
