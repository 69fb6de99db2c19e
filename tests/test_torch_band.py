"""The band path of the PyTorch port's sharded training, on the CPU (plain
K1, K2 and the reductions' twins): ``parallel/shard.py``'s
``rasterize_band`` against the JAX package's ``_band_fwd_at`` /
``_band_bwd_at`` (Pallas in interpret mode), and ``parallel/band_loss.py``
against JAX's ``band_loss_terms``.

The rasterizer cases: one seeded scene of 300 overlapping gaussians at
64×80, three tile rows, cut into 2 bands (one row of pad tiles) and into
3 bands (the last band's rows past the image zeroed), each band's forward
and its VJP under one seeded cotangent; one case under
``GSCREAM_REORDER=gather`` (K7's twin).

Tolerances:
* images: 1e-4 absolute except ≤ 0.1% of the pixels, where the T < 1e-4
  stop moves by one instance (JAX scans T in the log domain, the port
  multiplies);
* the VJP: ``assert_close_flip_aware`` of ``tests/test_torch_raster_bwd.py``
  (atol 2e-4·scale + rtol 2e-3, ≤ 2 elements within 2e-2·scale), for the
  same reason;
* the bands' gradients added up against the whole frame's, both the
  port's: rtol 1e-5 + 1e-6·scale (a gaussian whose run crosses a band
  boundary has its sums regrouped);
* ``band_loss_terms`` at one band: rtol 2e-5, as
  ``tests/test_sharded.py::test_band_loss_matches_global``; its gradient
  against ``train.step.loss_terms``': rtol 1e-4 + 1e-6·scale (the band
  form sums partials before it divides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (TH, TW, assert_close_flip_aware,
                                     gaussian_scene, jax_splats, to_torch,
                                     torch_binning)

W, H = 64, 80
CAP = 1 << 13
NAMES = ("mean2d", "conic", "opacity", "colors", "depth", "unc", "bg")


def _pad_jax(b, n_bands):
    """The JAX package's banded-grid padding (shard.py:213-232)."""
    gx, gy = W // TW, -(-H // TH)
    n_pad = (-(-gy // n_bands) * n_bands - gy) * gx
    if not n_pad:
        return b
    end = int(b.tile_start[-1] + b.tile_count[-1])
    return b._replace(
        tile_start=jnp.concatenate([b.tile_start,
                                    jnp.full((n_pad,), end, jnp.int32)]),
        tile_count=jnp.concatenate([b.tile_count,
                                    jnp.zeros((n_pad,), jnp.int32)]))


def _band_vjp(bb, n):
    """One band's JAX forward and VJP, jitted with the band index traced."""
    from gscream_tpu.parallel.shard import _band_bwd_at, _band_fwd_at

    @jax.jit
    def band_vjp(band, args, cot):
        o, res = _band_fwd_at(band, *args[:6], bb, args[6], W, H, n, True)
        return o, _band_bwd_at(band, W, H, n, True, res, cot)
    return band_vjp


@pytest.fixture(scope="module")
def case():
    """Each band's JAX forward and VJP, for 2 and 3 bands (one compile per
    band count, the band index traced)."""
    from gscream_tpu.ops.binning import bin_instances as jbin
    from gscream_tpu.ops.rasterize_tiled import TiledOut
    scene = gaussian_scene(3, n=300, thin=False)
    s = jax_splats(scene, W, H)
    b = jbin(s, CAP, W, H, TW, TH, expand="xla")
    assert int(b.num_instances) <= CAP
    _, _, _, colors, op, unc = scene
    args = (s.mean2d, s.conic, jnp.asarray(op), jnp.asarray(colors),
            s.depth, jnp.asarray(unc), jnp.asarray([0.1, 0.2, 0.3]))
    out = {"args": [np.asarray(a) for a in args], "binning": b}
    for n in (2, 3):
        bb = _pad_jax(b, n)
        bh = -(-(-(-H // TH)) // n) * TH
        rng = np.random.default_rng(11 + n)
        cots = [TiledOut(*(jnp.asarray(rng.normal(size=sh), jnp.float32)
                           for sh in ((bh, W, 3), (bh, W), (bh, W),
                                      (bh, W)))) for _ in range(n)]

        band_vjp = _band_vjp(bb, n)
        bands = []
        for band in range(n):
            o, g = band_vjp(jnp.int32(band), args, cots[band])
            g = g[:6] + g[7:]                 # drop the binning's zeros
            bands.append(dict(out=[np.asarray(x) for x in o],
                              grads=[np.asarray(x) for x in g],
                              cot=[np.asarray(x) for x in cots[band]]))
        out[n] = dict(bands=bands, binning=bb)
    return out


def _port_band(case, n, band, grad=True):
    from gscream_tpu_torch.parallel.shard import pad_tiles, rasterize_band
    leaves = [to_torch(a).requires_grad_(grad) for a in case["args"]]
    bb = pad_tiles(torch_binning(case["binning"]), W, H, n)
    out = rasterize_band(*leaves[:6], bb, leaves[6], W, H, n, band)
    if grad:
        torch.autograd.backward(
            list(out), [to_torch(c) for c in case[n]["bands"][band]["cot"]])
    return out, [x.grad for x in leaves]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("n", [2, 3])
def test_pad_tiles_follow_the_convention(case, n):
    """Pad tiles start at the last real tile's end with count 0, as the
    JAX package pads them (and ``test_pad_tiles_do_not_wipe_gradients``
    guards)."""
    from gscream_tpu_torch.parallel.shard import pad_tiles
    got = pad_tiles(torch_binning(case["binning"]), W, H, n)
    want = case[n]["binning"]
    np.testing.assert_array_equal(got.tile_start.numpy(),
                                  np.asarray(want.tile_start))
    np.testing.assert_array_equal(got.tile_count.numpy(),
                                  np.asarray(want.tile_count))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("n,reorder", [(2, "cm"), (3, "cm"), (2, "gather")])
def test_band_forward_and_vjp_match_jax(case, monkeypatch, n, reorder):
    monkeypatch.setenv("GSCREAM_REORDER", reorder)
    flips, worst = 0, {}
    for band in range(n):
        ref = case[n]["bands"][band]
        out, grads = _port_band(case, n, band)
        bad = np.zeros(ref["out"][1].shape, bool)
        for got, want in zip(out, ref["out"]):
            err = np.abs(got.detach().numpy() - want)
            bad |= (err.max(-1) if err.ndim == 3 else err) > 1e-4
        flips += int(bad.sum())
        for name, got, want in zip(NAMES, grads, ref["grads"]):
            worst[(band, name)] = assert_close_flip_aware(
                got.numpy(), want, f"band {band} of {n}: d {name}")
    assert flips <= 1e-3 * H * W, f"{flips} pixels beyond 1e-4"
    print(f"{n} bands, {reorder}: worst |port − JAX| / scale {worst}")


@pytest.mark.timeout(120)
@pytest.mark.parametrize("n", [2, 3])
def test_bands_add_up_to_the_frame(case, n):
    """The bands' images stitched are the whole frame's render (rows past
    the image zero), and their gradients add up to the frame's."""
    from gscream_tpu_torch.ops.rasterize_tiled import rasterize_tiled
    leaves = [to_torch(a).requires_grad_() for a in case["args"]]
    full = rasterize_tiled(*leaves[:6], torch_binning(case["binning"]),
                           leaves[6], W, H)
    cots = [np.concatenate([case[n]["bands"][b]["cot"][i]
                            for b in range(n)])[:H] for i in range(4)]
    torch.autograd.backward(list(full), [to_torch(c) for c in cots])
    total, images = None, []
    for band in range(n):
        out, grads = _port_band(case, n, band)
        images.append([x.detach() for x in out])
        total = grads if total is None else [a + g for a, g in
                                             zip(total, grads)]
    for i, f in enumerate(full):
        stitched = torch.cat([im[i] for im in images])
        assert torch.equal(stitched[:H], f.detach())
        assert not stitched[H:].any()
    for name, got, leaf in zip(NAMES, total, leaves):
        ref = leaf.grad.numpy()
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max(),
                                   err_msg=name)


def _loss_inputs(h, w):
    rng = np.random.default_rng(3)
    f32 = np.float32
    return dict(
        color=rng.uniform(size=(h, w, 3)).astype(f32),
        depth=rng.uniform(1.0, 4.0, size=(h, w)).astype(f32),
        unc=rng.uniform(size=(h, w)).astype(f32),
        t=rng.uniform(size=(h, w)).astype(f32),
        gt=rng.uniform(size=(3, h, w)).astype(f32),
        mask=(rng.uniform(size=(1, h, w)) > 0.6).astype(f32),
        mono=rng.uniform(1.0, 3.0, size=(1, h, w)).astype(f32),
        fgbox=(rng.uniform(size=(h, w)) > 0.5).astype(f32))


def _padded(x, bh, h):
    return np.pad(x, ((0, bh - h),) + ((0, 0),) * (x.ndim - 1))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("is_ref", [True, False])
@pytest.mark.parametrize("hw", [(64, 64), (48, 40)])
def test_band_loss_matches_jax_and_loss_terms(is_ref, hw):
    """``band_loss_terms`` at one band == JAX's (rtol 2e-5), including a
    sub-tile image height (the zero-padded SSIM border), and its gradient
    == ``loss_terms``' on the image's rows (the padding rows' gradient,
    which the SSIM windows of the last rows give them, is dropped by the
    band rasterizer's backward, as in the JAX package)."""
    from gscream_tpu.config import OptimConfig as JOpt
    from gscream_tpu.ops.rasterize_tiled import TiledOut as JOut
    from gscream_tpu.parallel.band_loss import band_loss_terms as jband
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.ops.rasterize_tiled import TiledOut
    from gscream_tpu_torch.parallel.band_loss import band_loss_terms
    from gscream_tpu_torch.train.step import loss_terms
    h, w = hw
    bh = -(-h // 32) * 32
    z = _loss_inputs(h, w)
    band = [_padded(z[k], bh, h) for k in ("color", "depth", "unc", "t")]

    @jax.jit
    def ref(band, gt, mask, mono, fgbox):
        return jband(JOut(*band), jnp.int32(0), gt, mask, mono, fgbox,
                     JOpt(), is_ref, h, w, "tiles", 1)
    l_ref, l1_ref = ref([jnp.asarray(x) for x in band], z["gt"], z["mask"],
                        z["mono"], z["fgbox"])
    leaves = [to_torch(x).requires_grad_() for x in band]
    data = [to_torch(z[k]) for k in ("gt", "mask", "mono", "fgbox")]
    loss, l1 = band_loss_terms(TiledOut(*leaves), 0, *data, OptimConfig(),
                               is_ref, h, w, None, 1, 0)
    np.testing.assert_allclose(loss.item(), float(l_ref), rtol=2e-5)
    np.testing.assert_allclose(l1.item(), float(l1_ref), rtol=2e-5)

    g_band = torch.autograd.grad(loss, leaves[:2])
    full = [to_torch(z[k]).requires_grad_() for k in ("color", "depth")]
    out = TiledOut(full[0], full[1], to_torch(z["unc"]), to_torch(z["t"]))
    g_full = torch.autograd.grad(
        loss_terms(out, *data, OptimConfig(), is_ref)[0], full)
    for gb, gf in zip(g_band, g_full):
        ref_g = gf.numpy()
        np.testing.assert_allclose(gb[:h].numpy(), ref_g, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref_g).max())
