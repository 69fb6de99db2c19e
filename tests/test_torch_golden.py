"""Golden gates of the PyTorch port's rasterizer: the frozen scene of
``tests/golden/golden_small.npz`` (float64 oracle outputs, input
gradients and fragility masks, ``tools/make_golden.py``) through the
port's float32 preprocess, binning and ``rasterize_tiled`` (the plain K1
and K2 on the CPU), and through the band path of the sharded step
(``parallel/shard.py::rasterize_band``, 2 bands, the images stitched and
the gradients added over the bands).  The bounds and fragility masks are
``tests/test_golden.py``'s: non-fragile pixels and gaussians within a
tight multiple of the scale, threshold-flip candidates within a loose
O(α_min) envelope.

The port bins row-tight only (``ops/binning.py``), so its preprocess
takes the opacities and its splats carry the α ≥ 1/255 iso-ellipse; an
instance row-tight emission leaves out is one no pixel blends, so the
render and its gradients are the full-rect emission's.
"""
import os

import numpy as np
import pytest
import torch

BUNDLE = os.path.join(os.path.dirname(__file__), "golden",
                      "golden_small.npz")
IMAGE = ("color", "depth", "uncertainty", "final_t")
GOLD_IMAGE = ("out_color", "out_depth", "out_unc", "out_final_t")
GRADS = ("g_mean2d", "g_conic", "g_opac", "g_colors", "g_depth", "g_unc")
# ~4x the relative errors measured when the bundle was frozen
# (tests/test_golden.py)
TIGHT = dict(g_mean2d=6e-5, g_conic=1e-5, g_opac=2e-5, g_colors=1e-5,
             g_depth=1e-5, g_unc=1e-5)


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(BUNDLE))


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _splats(z):
    from gscream_tpu_torch.ops.projection import preprocess
    return preprocess(_t(z["means"]), _t(z["scales"]), _t(z["quats"]),
                      _t(z["w2c"]), _t(z["full_proj"]), int(z["width"]),
                      int(z["height"]), _t(z["tan_fovx"]),
                      _t(z["tan_fovy"]), tile_w=32, tile_h=32,
                      opacity=_t(z["opac"]))


def _cot(z, c):
    """``tests/test_golden.py::_cot``: the bundle's fixed cotangents."""
    h, w = int(z["height"]), int(z["width"])
    y, x = np.meshgrid(np.arange(h, dtype=np.float64),
                       np.arange(w, dtype=np.float64), indexing="ij")
    base = np.sin(0.11 * x + 0.07 * y + 1.3 * c) * 0.5
    if c == 3:
        return np.stack([base, base * 0.7 + 0.1, base * -0.4], axis=-1)
    return base


def _gate(val, ref, fragile, tight, loose, name):
    """``tests/test_golden.py::_gate``."""
    err = np.abs(np.asarray(val, np.float64) - ref)
    scale = max(np.abs(ref).max(), 1e-3)
    fr = fragile
    while fr.ndim < err.ndim:
        fr = fr[..., None]
    fr = np.broadcast_to(fr, err.shape)
    worst_ok = err[~fr].max() if (~fr).any() else 0.0
    worst_fr = err[fr].max() if fr.any() else 0.0
    assert worst_ok <= tight * scale, (
        f"{name}: non-fragile err {worst_ok:.3e} > {tight:.1e}*{scale:.3e}")
    assert worst_fr <= loose * scale, (
        f"{name}: fragile err {worst_fr:.3e} > {loose:.1e}*{scale:.3e}")


def _run(z, n_bands):
    """The float32 render and its input gradients under the bundle's
    cotangents: the whole frame (``n_bands`` 0) or ``n_bands`` bands."""
    from gscream_tpu_torch.ops.binning import bin_instances
    from gscream_tpu_torch.ops.rasterize_tiled import rasterize_tiled
    from gscream_tpu_torch.parallel.shard import pad_tiles, rasterize_band
    w, h = int(z["width"]), int(z["height"])
    # the exact float64 splats rounded to float32 gate the rasterizer
    # alone; radius, rects and t_iso keep the float32 projection's
    s = _splats(z)._replace(mean2d=_t(z["mean2d"]), conic=_t(z["conic"]),
                            depth=_t(z["depth"]))
    binning = bin_instances(s, 8192, w, h, 32, 32)
    assert int(binning.num_instances) <= 8192
    leaves = [x.clone().requires_grad_() for x in (
        s.mean2d, s.conic, _t(z["opac"]), _t(z["colors"]), s.depth,
        _t(z["unc"]))]
    bg = _t(z["bg"])
    cots = [_t(_cot(z, c)) for c in (3, 0, 1, 2)]
    if not n_bands:
        out = rasterize_tiled(*leaves, binning, bg, w, h)
        torch.autograd.backward(list(out), cots)
        return [o.detach() for o in out], [x.grad for x in leaves]
    bands = []
    padded = pad_tiles(binning, w, h, n_bands)
    for band in range(n_bands):
        out = rasterize_band(*leaves, padded, bg, w, h, n_bands, band)
        bh = out.depth.shape[0]
        rows = slice(band * bh, min((band + 1) * bh, h))
        n = rows.stop - rows.start
        torch.autograd.backward(list(out), [torch.cat([c[rows], c.new_zeros(
            (bh - n,) + c.shape[1:])]) for c in cots])
        bands.append([o.detach()[:n] for o in out])
    return ([torch.cat([b[i] for b in bands]) for i in range(4)],
            [x.grad for x in leaves])


def test_projection_matches_f64(golden):
    """The port's float32 preprocess against the frozen float64 EWA
    projection (``test_golden.py``'s bounds)."""
    s = _splats(golden)
    assert np.abs(s.mean2d.numpy() - golden["mean2d"]).max() < 5e-5
    assert np.abs(s.conic.numpy() - golden["conic"]).max() < 2e-5
    assert np.abs(s.depth.numpy() - golden["depth"]).max() < 2e-6


@pytest.mark.parametrize("n_bands", [0, 2])
def test_forward_matches_golden(golden, n_bands):
    out, _ = _run(golden, n_bands)
    fpix = golden["fragile_pix"].astype(bool)
    for name, o, gold in zip(IMAGE, out, GOLD_IMAGE):
        _gate(o.numpy(), golden[gold], fpix, 5e-5, 2e-2, name)


@pytest.mark.parametrize("n_bands", [0, 2])
def test_backward_matches_golden(golden, n_bands):
    _, grads = _run(golden, n_bands)
    fg = golden["fragile_gauss"].astype(bool)
    for name, g in zip(GRADS, grads):
        _gate(g.numpy(), golden[name], fg, TIGHT[name], 3e-2, name)
