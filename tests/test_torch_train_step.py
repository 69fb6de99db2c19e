"""The phase-1 training slice: one port ``train_step`` (plain kernels, on
the CPU) against the JAX package's ``train_step`` (Pallas in interpret
mode), from the same state carried across with ``train_state_from_numpy``,
on the reference view and on another view.

The state is a seeded Scaffold-GS model (feat_dim 8, 2 offsets, anchor
capacity 256 with dead padded slots) at step 3, with Adam's second
moments and the densification statistics random and the first moments
zero, so the new first moment is 0.1·gradient: comparing ``m`` compares
every gradient leaf.  The targets are seeded images, not renders.

Tolerances, per leaf, with scale = max |JAX|:
* loss and l1: rtol 1e-5 (the renders differ by float32 rounding);
* gradients (``m``), ``v`` and the screen-gradient statistics:
  ``5e-3·scale + 2e-2·|JAX|``, with at most 0.5% of a leaf's elements
  (and at least 2) allowed beyond it but within ``5e-2·scale``.  The
  renders agree to ~1e-6 (decode and projection round differently, the
  JAX kernels scan T in the log domain); a gaussian whose α or T sits at
  a threshold (1/255, T < 1e-4) flips between the two and moves the
  gradients of its anchor by O(α); the sums over anchors in the MLP
  weights dilute but spread it;
* parameters: only where |g| > 1e-3·max |g| in the leaf (elsewhere Adam's
  normalized step turns rounding noise into a full step of either sign),
  the step taken within ``2e-2·|JAX step| + 1e-7`` outside the same flip
  budget; parameters the step does not update must be unchanged;
* ``StepAux`` counts and the visibility statistics equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import to_torch

W, H = 64, 32
CAP = 1 << 13
KW = dict(feat_dim=8, n_offsets=2, voxel_size=0.01, capacity=256)
FLIP_SHARE = 5e-3


def _targets():
    rng = np.random.default_rng(21)
    gt = rng.uniform(0.2, 0.8, (3, H, W)).astype(np.float32)
    mask = np.zeros((1, H, W), np.float32)
    mask[:, H // 4:3 * H // 4, W // 3:2 * W // 3] = 1.0
    ramp = np.linspace(0.0, 1.0, W, dtype=np.float32)[None, None, :]
    midas = (0.1 + 0.8 * ramp + 0.02 * rng.normal(size=(1, H, W))).astype(
        np.float32)
    fg_box = np.zeros((H, W), np.float32)
    fg_box[H // 8:7 * H // 8, W // 4:3 * W // 4] = 1.0
    return gt, mask, midas, fg_box


def _start_state(jcfg):
    """A seeded JAX ``TrainState`` at step 3, its leaves numpy arrays
    (built without JAX ops, which would compile one by one): 200 points
    voxelized into the 256 anchor slots, random features, offsets and
    decoders, m = 0, v and the statistics random."""
    from gscream_tpu.model.densify import DensifyStats
    from gscream_tpu.model.scaffold import (AnchorParams, MLPParams,
                                            ScaffoldState, voxelize)
    from gscream_tpu.ops.attention import BidirAttnParams
    from gscream_tpu.train.state import TrainState
    rng = np.random.default_rng(22)
    C, k, F = jcfg.capacity, jcfg.n_offsets, jcfg.feat_dim
    pts = voxelize(rng.normal(0, 0.6, (200, 3)), jcfg.voxel_size)
    n = pts.shape[0]

    def f32(x):
        return np.asarray(x, np.float32)

    def pad(x, fill):
        out = np.full((C,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out
    logit = float(np.log(0.1 / 0.9))
    params = AnchorParams(
        anchor=pad(pts, 0.0), offset=f32(rng.normal(0, 0.5, (C, k, 3))),
        feat=f32(rng.normal(0, 0.3, (C, F))),
        scaling=pad(f32(rng.uniform(-4.0, -2.5, (n, 6))), np.log(1e-3)),
        rotation=np.tile(f32([1, 0, 0, 0]), (C, 1)),
        opacity=np.full((C, 1), logit, np.float32),
        uncertainty=np.full((C, 1), logit, np.float32))

    def mlp(*dims):
        return [{"w": f32(rng.uniform(-1, 1, (a, b)) / np.sqrt(a)),
                 "b": f32(rng.uniform(-1, 1, b) / np.sqrt(a))}
                for a, b in zip(dims[:-1], dims[1:])]
    inner = jcfg.attn_heads * jcfg.attn_head_dim
    shapes = [(F, inner)] * 4 + [(inner, F), (F,), (inner, F), (F,)]
    ca = BidirAttnParams(*(f32(rng.uniform(-0.1, 0.1, sh)) for sh in shapes),
                         heads=jcfg.attn_heads, dim_head=jcfg.attn_head_dim)
    d_in = F + 4
    mlps = MLPParams(opacity=mlp(d_in, F, k), uncertainty=mlp(d_in, F, k),
                     cov=mlp(d_in, F, 7 * k), color=mlp(d_in, F, 3 * k),
                     crossattn=ca)
    tree = (params, mlps)
    m = jax.tree.map(np.zeros_like, tree)
    v = jax.tree.map(lambda x: f32(rng.uniform(0, 1e-6, x.shape)), tree)
    stats = DensifyStats(
        opacity_accum=f32(rng.integers(0, 3, (C, 1))),
        anchor_demon=f32(rng.integers(0, 3, (C, 1))),
        offset_grad_accum=f32(rng.uniform(0, 1e-3, (C, k))),
        offset_denom=f32(rng.integers(0, 3, (C, k))),
        grow_overflow=np.int32(0))
    scaffold = ScaffoldState(params=params, mlps=mlps,
                             alive=np.arange(C) < n,
                             xyz_max=pts.max(0).astype(np.float32))
    return TrainState(scaffold=scaffold, m=m, v=v, step=np.int32(3),
                      step_c=np.int32(0), stats=stats,
                      key=np.zeros(2, np.uint32))


@pytest.fixture(scope="module")
def steps():
    """Both packages' step from the same state, for is_ref True/False."""
    from gscream_tpu.cameras import make_camera as jmake
    from gscream_tpu.config import OptimConfig as JOpt
    from gscream_tpu.train.step import train_step as jstep
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig
    from gscream_tpu_torch.train.state import train_state_from_numpy
    from gscream_tpu_torch.train.step import train_step
    from gscream_tpu.model.scaffold import ScaffoldConfig as JCfg
    jcfg, cfg = JCfg(**KW), ScaffoldConfig(**KW)
    ts0 = _start_state(jcfg)
    R, T = np.eye(3), np.array([0.0, 0.0, 3.0])
    jcam = jmake(R, T, 1.0, 1.0 * H / W, W, H)
    cam = make_camera(R, T, 1.0, 1.0 * H / W, W, H, device="cpu")
    gt, mask, midas, fg_box = _targets()
    out = {}
    for is_ref in (True, False):
        jts, jaux = jstep(
            ts0, jcam, jnp.asarray(gt), jnp.asarray(mask),
            jnp.asarray(midas), jnp.asarray(fg_box),
            jnp.zeros(4, jnp.int32), cfg=jcfg, opt=JOpt(), is_ref=is_ref,
            use_crossattn=False, capacity=CAP, interpret=True, width=W,
            height=H, accumulate=True)
        ts = train_state_from_numpy(ts0, cfg, device="cpu")
        tts, aux = train_step(
            ts, cam, to_torch(gt), to_torch(mask), to_torch(midas),
            to_torch(fg_box), cfg=cfg, opt=OptimConfig(), is_ref=is_ref,
            capacity=CAP, width=W, height=H, accumulate=True)
        out[is_ref] = dict(
            jax=train_state_from_numpy(jax.tree.map(np.asarray, jts), cfg,
                                       device="cpu"),
            jaux=jax.tree.map(np.asarray, jaux), port=tts, aux=aux,
            start=train_state_from_numpy(ts0, cfg, device="cpu"))
    return out


def _close(got, ref, name, atol=5e-3, rtol=2e-2, flip_rel=5e-2,
           where=None):
    """Tight bound except a few (threshold-flip) elements; returns the
    worst error relative to the leaf's scale."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    if where is not None:
        got, ref = got[where], ref[where]
    if ref.size == 0:
        return 0.0
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref)
    bad = err > atol * scale + rtol * np.abs(ref)
    assert bad.sum() <= max(2, FLIP_SHARE * ref.size), (
        f"{name}: {int(bad.sum())} of {ref.size} beyond the tight bound, "
        f"worst {err.max() / scale:.3e} of scale")
    assert err.max() <= flip_rel * scale, (
        f"{name}: worst {err.max() / scale:.3e} of scale")
    return float(err.max() / scale)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("is_ref", [True, False])
def test_loss_and_aux_match(steps, is_ref):
    r = steps[is_ref]
    np.testing.assert_allclose(float(r["aux"].loss), float(r["jaux"].loss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(r["aux"].l1), float(r["jaux"].l1),
                               rtol=1e-5)
    assert int(r["aux"].num_instances) == int(r["jaux"].num_instances)
    assert int(r["aux"].num_instances) <= CAP
    assert int(r["aux"].n_active) == int(r["jaux"].n_active)
    assert not bool(r["aux"].cross_ok)
    np.testing.assert_allclose(r["aux"].packed.numpy(), r["jaux"].packed,
                               rtol=1e-5)
    assert r["port"].step == 4 == r["jax"].step


@pytest.mark.timeout(120)
@pytest.mark.parametrize("is_ref", [True, False])
def test_gradients_and_moments_match(steps, is_ref):
    r = steps[is_ref]
    worst = {}
    for name, ref in r["jax"].m.items():
        got = r["port"].m[name]
        if not ref.any():
            # a group the step does not update, or one without gradient
            np.testing.assert_array_equal(got.numpy(), ref.numpy(), name)
            continue
        worst[name] = _close(got, ref, f"m {name}")
        _close(r["port"].v[name], r["jax"].v[name], f"v {name}")
    assert len(worst) >= 10, sorted(worst)
    print(f"is_ref={is_ref}: worst |Δm| / scale per leaf {worst}")


@pytest.mark.timeout(120)
@pytest.mark.parametrize("is_ref", [True, False])
def test_parameters_match(steps, is_ref):
    from gscream_tpu_torch.train.state import named_params
    r = steps[is_ref]
    p0 = named_params(r["start"].scaffold)
    pj = named_params(r["jax"].scaffold)
    pt = named_params(r["port"].scaffold)
    for name, start in p0.items():
        start = start.detach().numpy()
        dj = pj[name].detach().numpy() - start
        dt = pt[name].detach().numpy() - start
        g = np.abs(r["jax"].m[name].numpy())
        if not dj.any():
            np.testing.assert_array_equal(dt, dj, name)
            continue
        sel = g > 1e-3 * g.max()
        _close(dt, dj, f"step of {name}", atol=1e-7 / max(
            np.abs(dj[sel]).max(), 1e-30), where=sel)


@pytest.mark.timeout(120)
def test_step_finite_on_degenerate_scene():
    """Gaussians the render must ignore — dead capacity slots, anchors
    behind the camera, in its plane, at its centre, far off-screen, and
    neural opacity ≤ 0 — leave every gradient (``m``), moment, parameter
    and statistic of a port step finite: no ``0·∞`` through a masked
    branch."""
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.model.scaffold import (ScaffoldConfig, decode,
                                                  init_scaffold)
    from gscream_tpu_torch.train.state import init_train_state, named_params
    from gscream_tpu_torch.train.step import train_step
    rng = np.random.default_rng(41)
    pts = np.concatenate([
        rng.normal(0, 0.6, (80, 3)),                       # in view
        rng.normal(0, 0.6, (20, 3)) + [0, 0, -6.0],        # behind
        rng.normal(0, 0.3, (10, 3)) * [1, 1, 0] + [0, 0, -3.0],  # plane
        [[0.0, 0.0, -3.0]],                                # the centre
        rng.normal(0, 0.5, (20, 3)) + [25.0, 0, 0],        # off-screen
    ]).astype(np.float32)
    cfg = ScaffoldConfig(**KW)
    st = init_scaffold(pts, cfg, torch.Generator().manual_seed(1),
                       device="cpu")
    p = st.params
    st = st._replace(params=p._replace(
        feat=to_torch(rng.normal(0, 0.3, p.feat.shape).astype(np.float32)),
        offset=to_torch(rng.normal(0, 0.5, p.offset.shape).astype(
            np.float32))))
    assert not bool(st.alive.all())                        # dead slots
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 1.0,
                      1.0 * H / W, W, H, device="cpu")
    with torch.no_grad():
        dec = decode(st, cam.cam_center, None, cfg)
    assert bool((dec.neural_opacity[st.alive] <= 0).any())
    gt, mask, midas, fg_box = _targets()
    ts = init_train_state(st, cfg)
    for is_ref in (True, False):
        ts, aux = train_step(
            ts, cam, to_torch(gt), to_torch(mask), to_torch(midas),
            to_torch(fg_box), cfg=cfg, opt=OptimConfig(), is_ref=is_ref,
            capacity=CAP, width=W, height=H, accumulate=True)
        assert torch.isfinite(aux.packed).all()
    for name, t in named_params(ts.scaffold).items():
        for what, x in (("param", t), ("m", ts.m[name]), ("v", ts.v[name])):
            assert torch.isfinite(x).all(), (what, name)
    assert ts.m["params/offset"].abs().max() > 0
    for f, x in zip(ts.stats._fields, ts.stats):
        assert torch.isfinite(x.float()).all(), f


@pytest.mark.timeout(120)
@pytest.mark.parametrize("is_ref", [True, False])
def test_densify_stats_match(steps, is_ref):
    r = steps[is_ref]
    got, ref = r["port"].stats, r["jax"].stats
    for f in ("opacity_accum", "anchor_demon", "offset_denom"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(ref, f).numpy(), rtol=1e-6,
                                   err_msg=f)
    start = r["start"].stats.offset_grad_accum.numpy()
    _close(got.offset_grad_accum.numpy() - start,
           ref.offset_grad_accum.numpy() - start, "offset_grad_accum")
    assert (got.offset_denom - r["start"].stats.offset_denom).sum() > 0
