"""Port parity: the training losses and SSIM, values and gradients,
against the JAX package (``gscream_tpu/ops/losses.py``, ``ops/ssim.py``)
on seeded 3×32×48 images with flat regions, where |x| and the SSIM
variance clamp sit exactly at their kinks (both packages take JAX's
one-sided |x|' = +1 at 0 and split a max/min tie ½/½).

Tolerance: values rtol 1e-5; gradients 1e-5·max|JAX| + rtol 1e-4 (sums
over the image are taken in another order; SSIM's blur is an XLA
convolution in JAX and a grouped ``F.conv2d`` in the port).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import to_torch

C, H, W = 3, 32, 48


def _inputs():
    rng = np.random.default_rng(31)
    gt = rng.uniform(0, 1, (C, H, W)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(
        np.float32)
    pred[:, :8, :12] = gt[:, :8, :12]           # exact ties
    pred[:, -6:, :] = 0.0                       # flat regions
    gt[:, -6:, :] = 0.0
    mask = np.zeros((1, H, W), np.float32)
    mask[:, 8:24, 16:36] = 1.0
    depth = rng.uniform(1, 4, (H, W)).astype(np.float32)
    depth[-6:, :] = 0.0                         # uncovered pixels
    midas = (0.1 + 0.2 * depth + rng.normal(0, 0.05, (H, W))).astype(
        np.float32)
    fg = np.zeros((H, W), np.float32)
    fg[4:28, 10:40] = 1.0
    return dict(pred=pred, gt=gt, mask=mask, depth=depth, midas=midas,
                fg=fg)


# (name, the function given its module, argument names; the first
# argument is the one differentiated)
CASES = [
    ("l1_loss", lambda J: J.l1_loss, ("pred", "gt")),
    ("l1_loss_masked", lambda J: J.l1_loss_masked, ("pred", "gt", "mask")),
    ("gradient_loss", lambda J: J.gradient_loss, ("depth", "midas", "fg")),
    ("multiscale_gradient_loss", lambda J: J.multiscale_gradient_loss,
     ("depth", "midas", "fg")),
    ("align_depth", lambda J: (lambda d, m, v: J.align_depth(d, m, v).sum()),
     ("depth", "midas", "fg")),
    ("depth_loss_ref", lambda J: (lambda d, m, g, f: J.depth_loss_ref(
        d, m, g, f, 1.0, 100.0, 1.0)), ("depth", "midas", "mask0", "fg")),
    ("depth_loss_other", lambda J: (lambda d, m, g: J.depth_loss_other(
        d, m, g, 0.1, 0.1)), ("depth", "midas", "mask0")),
    ("ssim", lambda S: S.ssim, ("pred", "gt")),
    ("ssim_masked", lambda S: S.ssim_masked, ("pred", "gt", "mask")),
]


def _args(names):
    d = _inputs()
    d["mask0"] = d["mask"][0]
    return [d[n] for n in names]


@pytest.fixture(scope="module")
def references():
    """Every case's JAX value and gradient, from one compiled program."""
    import gscream_tpu.ops.losses as jl
    import gscream_tpu.ops.ssim as js

    @jax.jit
    def run(args):
        return {name: jax.value_and_grad(
            get(js if name.startswith("ssim") else jl))(*args[name])
            for name, get, _ in CASES}
    return jax.tree.map(np.asarray, run(
        {name: [jnp.asarray(a) for a in _args(names)]
         for name, _, names in CASES}))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("name,get,names", CASES, ids=[c[0] for c in CASES])
def test_loss_value_and_gradient_match(references, name, get, names):
    import gscream_tpu_torch.ops.losses as tl
    import gscream_tpu_torch.ops.ssim as ts
    ref, gref = references[name]
    targs = [to_torch(a) for a in _args(names)]
    targs[0].requires_grad_()
    got = get(ts if name.startswith("ssim") else tl)(*targs)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    assert np.abs(gref).max() > 0
    np.testing.assert_allclose(targs[0].grad.numpy(), gref, rtol=1e-4,
                               atol=1e-5 * np.abs(gref).max())


@pytest.mark.timeout(120)
def test_scale_shift_and_psnr_match():
    import gscream_tpu.ops.losses as jl
    import gscream_tpu_torch.ops.losses as tl
    d = _inputs()
    for mask in (d["fg"], np.zeros_like(d["fg"])):      # singular → (0, 0)
        ref = jl.compute_scale_and_shift(*(jnp.asarray(x) for x in (
            d["depth"], d["midas"], mask)))
        got = tl.compute_scale_and_shift(*(to_torch(x) for x in (
            d["depth"], d["midas"], mask)))
        np.testing.assert_allclose([float(g) for g in got],
                                   [float(r) for r in ref], rtol=1e-5)
    for mask in (None, d["mask"]):
        ref = jl.psnr(jnp.asarray(d["pred"]), jnp.asarray(d["gt"]),
                      None if mask is None else jnp.asarray(mask))
        got = tl.psnr(to_torch(d["pred"]), to_torch(d["gt"]),
                      None if mask is None else to_torch(mask))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
