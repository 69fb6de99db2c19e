"""Port parity: the bfloat16 loss head (``OptimConfig.loss_dtype =
"bfloat16"``: the RGB L1/SSIM maps in bfloat16, their means in float32,
the depth terms and the render in float32; JAX step.py:171-173,
losses.py:24-37, ssim.py:41-43, :82, :90).

* The port's bfloat16 ``loss_terms`` against its float32 ones, with the
  bounds of ``tests/test_bf16_losses.py`` (loss within 2%, each input
  gradient's cosine above 0.995 and its error below 5% of its norm).
* The port's bfloat16 ``loss_terms`` against JAX's: the loss within 1e-5
  relative, each input gradient's cosine above 0.9999 and its error below
  1% of its norm (measured: 1.6e-7, 0.999998 and 0.17%).  Both round to
  bfloat16 after every map operation in principle, but XLA's CPU
  backend may keep a fused chain in float32 (its excess precision), and
  the two convolutions sum their taps in other orders.
* One ``train_step`` with ``loss_dtype="bfloat16"`` against JAX's, from
  ``tests/test_torch_train_step.py``'s state: the loss within 1e-5
  relative, each gradient leaf (the new first moment) at a cosine above
  0.9999 and within that file's flip-aware bound (measured: every element
  within its tight bound, the worst 0.33% of a leaf's scale).
* The band losses (``parallel/band_loss.py``), which like JAX's compute
  in float32 whatever the dtype: bit-equal at both dtypes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import to_torch


def _scene(seed, h=96, w=128):
    """``tests/test_bf16_losses.py``'s inputs."""
    rng = np.random.default_rng(seed)
    color = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    depth = rng.uniform(2, 8, (h, w)).astype(np.float32)
    gt = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    mask = np.zeros((1, h, w), np.float32)
    mask[0, 20:60, 30:90] = 1.0
    midas = rng.uniform(0, 1, (1, h, w)).astype(np.float32)
    return color, depth, gt, mask, midas, mask[0].copy()


def _port(dtype, is_ref, scene):
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.ops.rasterize_tiled import TiledOut
    from gscream_tpu_torch.train.step import loss_terms
    color, depth, *rest = (to_torch(x) for x in scene)
    color.requires_grad_()
    depth.requires_grad_()
    out = TiledOut(color, depth, torch.zeros_like(depth),
                   torch.zeros_like(depth))
    loss, l1 = loss_terms(out, *rest, OptimConfig(loss_dtype=dtype), is_ref)
    assert loss.dtype == l1.dtype == torch.float32
    loss.backward()
    return loss.item(), [color.grad.double().numpy(),
                         depth.grad.double().numpy()]


def _jax(dtype, is_ref, scene):
    from gscream_tpu.config import OptimConfig
    from gscream_tpu.ops.rasterize_tiled import TiledOut
    from gscream_tpu.train.step import loss_terms
    color, depth, gt, mask, midas, fg = (jnp.asarray(x) for x in scene)

    def f(color, depth):
        out = TiledOut(color, depth, jnp.zeros_like(depth),
                       jnp.zeros_like(depth))
        return loss_terms(out, gt, mask, midas, fg,
                          OptimConfig(loss_dtype=dtype), is_ref)[0]
    loss, grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(color,
                                                                 depth)
    return float(loss), [np.asarray(g, np.float64) for g in grads]


def _cos(a, b):
    return float(np.sum(a * b) / max(np.linalg.norm(a) * np.linalg.norm(b),
                                      1e-30))


@pytest.mark.timeout(120)
@pytest.mark.parametrize("is_ref", [True, False])
def test_bf16_losses_match_fp32(is_ref):
    scene = _scene(0)
    l32, g32 = _port("float32", is_ref, scene)
    l16, g16 = _port("bfloat16", is_ref, scene)
    assert abs(l16 - l32) <= 2e-2 * abs(l32), (l16, l32)
    for a, b in zip(g16, g32):
        assert _cos(a, b) > 0.995
        assert np.linalg.norm(a - b) <= 5e-2 * np.linalg.norm(b)
    assert l16 != l32                       # the bfloat16 path did run


@pytest.mark.timeout(120)
@pytest.mark.parametrize("is_ref", [True, False])
def test_bf16_losses_match_jax(is_ref):
    scene = _scene(1)
    lp, gp = _port("bfloat16", is_ref, scene)
    lj, gj = _jax("bfloat16", is_ref, scene)
    assert abs(lp - lj) <= 1e-5 * abs(lj), (lp, lj)
    for a, b in zip(gp, gj):
        assert _cos(a, b) > 0.9999, _cos(a, b)
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b)


@pytest.mark.timeout(180)
def test_bf16_train_step_matches_jax():
    from gscream_tpu.cameras import make_camera as jmake
    from gscream_tpu.config import OptimConfig as JOpt
    from gscream_tpu.model.scaffold import ScaffoldConfig as JCfg
    from gscream_tpu.train.step import train_step as jstep
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig
    from gscream_tpu_torch.train.state import train_state_from_numpy
    from gscream_tpu_torch.train.step import train_step
    from tests.test_torch_train_step import (CAP, H, KW, W, _close,
                                             _start_state, _targets)
    jcfg, cfg = JCfg(**KW), ScaffoldConfig(**KW)
    ts0 = _start_state(jcfg)
    R, T = np.eye(3), np.array([0.0, 0.0, 3.0])
    gt, mask, midas, fg_box = _targets()
    jts, jaux = jstep(
        ts0, jmake(R, T, 1.0, 1.0 * H / W, W, H), jnp.asarray(gt),
        jnp.asarray(mask), jnp.asarray(midas), jnp.asarray(fg_box),
        jnp.zeros(4, jnp.int32), cfg=jcfg,
        opt=JOpt(loss_dtype="bfloat16"), is_ref=True, use_crossattn=False,
        capacity=CAP, interpret=True, width=W, height=H, accumulate=True)
    ref = train_state_from_numpy(jax.tree.map(np.asarray, jts), cfg,
                                 device="cpu")
    opt = OptimConfig(loss_dtype="bfloat16")
    assert dataclasses.replace(opt, loss_dtype="float32") == OptimConfig()
    ts, aux = train_step(
        train_state_from_numpy(ts0, cfg, device="cpu"),
        make_camera(R, T, 1.0, 1.0 * H / W, W, H, device="cpu"),
        to_torch(gt), to_torch(mask), to_torch(midas), to_torch(fg_box),
        cfg=cfg, opt=opt, is_ref=True, capacity=CAP, width=W, height=H,
        accumulate=True)
    assert abs(float(aux.loss) - float(jaux.loss)) <= 1e-5 * abs(
        float(jaux.loss))
    assert int(aux.num_instances) == int(jaux.num_instances) <= CAP
    n = 0
    for name, r in ref.m.items():
        if not r.any():
            continue
        got = ts.m[name].double().numpy()
        assert _cos(got.ravel(), r.double().numpy().ravel()) > 0.9999, name
        _close(got, r, f"m {name}")
        n += 1
    assert n >= 10


@pytest.mark.timeout(120)
@pytest.mark.parametrize("is_ref", [True, False])
def test_band_loss_ignores_dtype(is_ref):
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.ops.rasterize_tiled import TiledOut
    from gscream_tpu_torch.parallel.band_loss import band_loss_terms
    h, w = 64, 64
    color, depth, gt, mask, midas, fg = _scene(2, h, w)
    out = TiledOut(to_torch(color), to_torch(depth),
                   torch.zeros(h, w), torch.zeros(h, w))
    data = [to_torch(x) for x in (gt, mask, midas, fg)]
    res = [band_loss_terms(out, 0, *data, OptimConfig(loss_dtype=dt),
                           is_ref, h, w, None, 1, 0)
           for dt in ("float32", "bfloat16")]
    for a, b in zip(*res):
        assert a.dtype == torch.float32 and torch.equal(a, b)
