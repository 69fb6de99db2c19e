"""Port parity: the tile forward (plain K1) against the JAX
``rasterize_tiled`` forward in Pallas interpret mode, on the same JAX
``Splats`` and ``Binning``.

Tolerance: color, depth, uncertainty and final T within 1e-4 absolute,
except at pixels where the ``T < 1e-4`` early stop flips for one
instance.  The JAX kernel computes the transmittance as a log-domain
prefix scan over rows of 8 instances; the port keeps the sequential
recurrence ``T ← T·(1−α)`` of the CUDA original.  The two differ only by
rounding, which can move a pixel's stop by one instance; such pixels are
counted and held to ≤ 0.1% of the image.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (TH, TW, gaussian_scene, jax_splats,
                                     to_torch, torch_binning, torch_splats)

W, H = 64, 32


def _scene(seed, thin):
    from gscream_tpu.ops.binning import bin_instances as jbin
    scene = gaussian_scene(seed, n=300, thin=thin)
    s = jax_splats(scene, W, H)
    b = jbin(s, 1 << 13, W, H, TW, TH, expand="xla")
    assert int(b.num_instances) <= 1 << 13
    return scene, s, b


def test_pack_instance_data_matches():
    from gscream_tpu.ops import rasterize_tiled as jrt
    from gscream_tpu_torch.ops import rasterize_tiled as trt
    (_, _, _, colors, op, unc), s, b = _scene(0, True)
    args = (s.mean2d, s.conic, jnp.asarray(op), jnp.asarray(colors),
            s.depth, jnp.asarray(unc))
    a = np.asarray(jrt.pack_instance_data(*args, b, W // TW))
    tb = torch_binning(b)
    got = trt.pack_instance_data(*(to_torch(x) for x in args), tb, W // TW)
    cap = tb.gauss_id.shape[0]
    assert got.shape == (cap, 16) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), a.reshape(-1, 16)[:cap])


@pytest.mark.parametrize("seed,thin", [(1, True), (2, False)])
def test_forward_matches_jax(seed, thin):
    from gscream_tpu.ops import rasterize_tiled as jrt
    from gscream_tpu_torch.ops import rasterize_tiled as trt
    (_, _, _, colors, op, unc), s, b = _scene(seed, thin)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    args = (s.mean2d, s.conic, jnp.asarray(op), jnp.asarray(colors),
            s.depth, jnp.asarray(unc))
    a = jrt.rasterize_tiled(*args, b, jnp.asarray(bg), W, H, True)
    with torch.no_grad():
        got = trt.rasterize_tiled(*(to_torch(x) for x in args),
                                  torch_binning(b), to_torch(bg), W, H)
    assert float(np.asarray(a.final_t).mean()) < 0.9   # non-trivial cover
    flips = np.zeros((H, W), bool)
    for f in ("color", "depth", "uncertainty", "final_t"):
        err = np.abs(getattr(got, f).numpy() - np.asarray(getattr(a, f)))
        if err.ndim == 3:
            err = err.max(-1)
        flips |= err > 1e-4
    assert flips.sum() <= 1e-3 * H * W, (f"{flips.sum()} pixels beyond "
                                         "1e-4")


def test_forward_passes_gradients():
    """With inputs that require grad the rasterizer records its backward:
    a loss on the outputs reaches every differentiable argument, with
    finite values, and the same forward values as under no_grad."""
    from gscream_tpu_torch.ops import rasterize_tiled as trt
    from gscream_tpu_torch.ops.binning import bin_instances
    (_, _, _, colors, op, unc), s, _ = _scene(0, True)
    ts = torch_splats(s)
    tb = bin_instances(ts, 1 << 13, W, H, TW, TH)
    leaves = [x.clone().requires_grad_() for x in (
        ts.mean2d, ts.conic, to_torch(op), to_torch(colors), ts.depth,
        to_torch(unc), torch.full((3,), 0.25))]
    out = trt.rasterize_tiled(*leaves[:6], tb, leaves[6], W, H)
    with torch.no_grad():
        ref = trt.rasterize_tiled(*leaves[:6], tb, leaves[6], W, H)
    for a, b in zip(out, ref):
        assert torch.equal(a.detach(), b)
    sum(o.sum() for o in out).backward()
    for x in leaves:
        assert x.grad is not None and torch.isfinite(x.grad).all()
        assert x.grad.abs().max() > 0
