"""Phase 2 of the training step: one port ``train_step`` with
``use_crossattn=True`` (plain kernels, on the CPU) against the JAX
package's (Pallas in interpret mode), from the state of
``tests/test_torch_train_step.py`` carried across with
``train_state_from_numpy``, on the reference view and on another view,
with a token patch that samples enough anchors (``cross_ok`` True) and
one that samples none (``cross_ok`` False).

The token draws are JAX's: the port's ``token_priorities`` is replaced by
the uniform draws JAX's step makes under the state's key, so both
packages pick the same tokens (checked directly against JAX's
``sample_cross_tokens``).  Tolerances are those of
``tests/test_torch_train_step.py`` (module docstring): loss rtol 1e-5;
gradients (``m``), ``v`` and the EMA-mixed features within
``5e-3·scale + 2e-2·|JAX|`` outside a flip budget of 0.5% of a leaf;
parameter steps where the gradient is not noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (  # noqa: F401
    to_torch, two_torch_threads)
from tests.test_torch_train_step import (CAP, KW, H, W, _close,
                                         _start_state, _targets)

BOXES = {True: (0, H, 0, W),          # the whole image: cross_ok True
         False: (0, 3, 0, 3)}         # a corner with no anchor: False


def _jax_priorities(key, n):
    """The draws JAX's ``train_step`` makes from ``ts.key`` (step.py:222-
    226, 147-150)."""
    _, k_cross = jax.random.split(key)
    k_cross = jax.random.fold_in(k_cross, 0)
    kf, kb = jax.random.split(k_cross)
    return (to_torch(jax.random.uniform(kf, (n,))),
            to_torch(jax.random.uniform(kb, (n,))))


@pytest.fixture(scope="module")
def steps():
    """Both packages' phase-2 step from one state, for each (is_ref,
    cross_ok)."""
    from gscream_tpu.cameras import make_camera as jmake
    from gscream_tpu.config import OptimConfig as JOpt
    from gscream_tpu.model.scaffold import ScaffoldConfig as JCfg
    from gscream_tpu.train.step import train_step as jstep
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig
    from gscream_tpu_torch.train import step as port_step
    from gscream_tpu_torch.train.state import train_state_from_numpy
    jcfg, cfg = JCfg(**KW), ScaffoldConfig(**KW)
    ts0 = _start_state(jcfg)
    ts0 = ts0._replace(key=np.asarray(jax.random.PRNGKey(5)),
                       step_c=np.int32(2))
    R, T = np.eye(3), np.array([0.0, 0.0, 3.0])
    jcam = jmake(R, T, 1.0, 1.0 * H / W, W, H)
    cam = make_camera(R, T, 1.0, 1.0 * H / W, W, H, device="cpu")
    gt, mask, midas, fg_box = _targets()
    pri = _jax_priorities(jnp.asarray(ts0.key), cfg.capacity)
    saved = port_step.token_priorities
    port_step.token_priorities = lambda ts, n: pri
    out = {}
    try:
        for is_ref in (True, False):
            for ok in (True, False):
                box = np.asarray(BOXES[ok], np.int32)
                jts, jaux = jstep(
                    ts0, jcam, jnp.asarray(gt), jnp.asarray(mask),
                    jnp.asarray(midas), jnp.asarray(fg_box),
                    jnp.asarray(box), cfg=jcfg, opt=JOpt(), is_ref=is_ref,
                    use_crossattn=True, capacity=CAP, interpret=True,
                    width=W, height=H, accumulate=True)
                ts = train_state_from_numpy(ts0, cfg, device="cpu")
                tts, aux = port_step.train_step(
                    ts, cam, to_torch(gt), to_torch(mask), to_torch(midas),
                    to_torch(fg_box), to_torch(box), cfg=cfg,
                    opt=OptimConfig(), is_ref=is_ref, use_crossattn=True,
                    capacity=CAP, width=W, height=H, accumulate=True)
                out[is_ref, ok] = dict(
                    jax=train_state_from_numpy(jax.tree.map(np.asarray, jts),
                                               cfg, device="cpu"),
                    jaux=jax.tree.map(np.asarray, jaux), port=tts, aux=aux,
                    start=train_state_from_numpy(ts0, cfg, device="cpu"))
    finally:
        port_step.token_priorities = saved
    return out


CASES = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("is_ref,ok", CASES)
def test_loss_aux_and_counts_match(steps, is_ref, ok):
    r = steps[is_ref, ok]
    assert bool(r["aux"].cross_ok) == bool(r["jaux"].cross_ok) == ok
    np.testing.assert_allclose(r["aux"].packed.numpy(), r["jaux"].packed,
                               rtol=1e-5)
    assert int(r["aux"].num_instances) <= CAP
    assert r["port"].step == int(r["jax"].step) == 4
    assert r["port"].step_c == int(r["jax"].step_c) == 2 + ok


@pytest.mark.timeout(120)
def test_tokens_match_jax():
    """The port's ``sample_cross_tokens`` on JAX's priorities picks JAX's
    valid fg/bg slots, in JAX's order, with the same counts and flag."""
    from gscream_tpu.train.step import sample_cross_tokens as jsample
    from gscream_tpu_torch.train.step import sample_cross_tokens
    rng = np.random.default_rng(51)
    n, w, h = 300, 64, 32
    pos = np.stack([rng.uniform(-8, w + 8, n), rng.uniform(-8, h + 8, n)],
                   -1).astype(np.float32)
    vis, alive = rng.uniform(size=n) < 0.9, rng.uniform(size=n) < 0.95
    gmask = np.zeros((h, w), np.float32)
    gmask[8:24, 20:44] = 1.0
    box = np.array([2, 30, 4, 60], np.int32)
    key = jax.random.PRNGKey(9)
    kf, kb = jax.random.split(key)
    pri = (jax.random.uniform(kf, (n,)), jax.random.uniform(kb, (n,)))
    for cap in (16, 256):
        j = jsample(key, jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1]),
                    jnp.asarray(vis), jnp.asarray(alive), jnp.asarray(gmask),
                    jnp.asarray(box), w, h, cap)
        t = sample_cross_tokens(tuple(to_torch(p) for p in pri),
                                to_torch(pos[:, 0]), to_torch(pos[:, 1]),
                                to_torch(vis), to_torch(alive),
                                to_torch(gmask), to_torch(box), w, h, cap)
        j = [np.asarray(x) for x in j]
        assert bool(t.ok) == bool(j[4]) and bool(t.ok)
        for got_i, got_v, ref_i, ref_v in ((t.fg_idx, t.fg_valid, j[0], j[2]),
                                           (t.bg_idx, t.bg_valid, j[1], j[3])):
            np.testing.assert_array_equal(got_v.numpy(), ref_v)
            np.testing.assert_array_equal(got_i.numpy()[ref_v], ref_i[ref_v])
        assert 0 < j[2].sum() <= cap


@pytest.mark.timeout(120)
@pytest.mark.parametrize("is_ref,ok", CASES)
def test_gradients_and_moments_match(steps, is_ref, ok):
    """Every moment against JAX's (the cross-attention's among them: its
    first moments are 0.1·gradient); with ``cross_ok`` False nothing
    moves in either package."""
    r = steps[is_ref, ok]
    start = r["start"]
    moved = 0
    for name, ref in r["jax"].m.items():
        got = r["port"].m[name]
        if torch.equal(ref, start.m[name]):
            np.testing.assert_array_equal(got.numpy(), ref.numpy(), name)
            np.testing.assert_array_equal(r["port"].v[name].numpy(),
                                          r["jax"].v[name].numpy(), name)
            continue
        moved += 1
        _close(got, ref, f"m {name}")
        _close(r["port"].v[name], r["jax"].v[name], f"v {name}")
    if ok:
        ca = [n for n in r["jax"].m if n.startswith("mlps/crossattn/")
              and r["jax"].m[n].any()]
        # off the reference view the fg output is never written, so the
        # sequence side's value and output arrays get no gradient
        assert len(ca) == (8 if is_ref else 5), ca
        assert moved >= 16
        assert not r["port"].m["params/feat"].any()   # feat stays frozen
    else:
        assert moved == 0


@pytest.mark.timeout(120)
@pytest.mark.parametrize("is_ref,ok", CASES)
def test_parameters_match(steps, is_ref, ok):
    """Each parameter's step against JAX's where the gradient is not
    noise; the anchor features against JAX's EMA-mixed features (written
    back into the state, not stepped by the main Adam)."""
    from gscream_tpu_torch.train.state import named_params
    r = steps[is_ref, ok]
    p0 = named_params(r["start"].scaffold)
    pj = named_params(r["jax"].scaffold)
    pt = named_params(r["port"].scaffold)
    for name, start in p0.items():
        start = start.detach().numpy()
        dj = pj[name].detach().numpy() - start
        dt = pt[name].detach().numpy() - start
        if name == "params/feat":
            _close(pt[name].detach(), pj[name].detach(), "EMA-mixed feat")
            assert (np.abs(dt).max(1) > 0).sum() == (
                np.abs(dj).max(1) > 0).sum()
            if ok:   # fg rows written on the reference view only
                assert (np.abs(dj).max(1) > 0).sum() > 12 * (1 + is_ref)
            else:
                assert not dj.any()
            continue
        if not dj.any():
            np.testing.assert_array_equal(dt, dj, name)
            continue
        g = np.abs(r["jax"].m[name].numpy())
        sel = g > 1e-3 * g.max()
        _close(dt, dj, f"step of {name}", atol=1e-7 / max(
            np.abs(dj[sel]).max(), 1e-30), where=sel)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("is_ref,ok", CASES)
def test_stats_accumulate(steps, is_ref, ok):
    """The densification statistics accumulate on every phase-2 step,
    ``cross_ok`` or not."""
    r = steps[is_ref, ok]
    got, ref = r["port"].stats, r["jax"].stats
    for f in ("opacity_accum", "anchor_demon", "offset_denom"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   getattr(ref, f).numpy(), rtol=1e-6,
                                   err_msg=f)
    assert (got.anchor_demon - r["start"].stats.anchor_demon).sum() > 0


@pytest.mark.timeout(120)
def test_feat_frozen_phase1_step():
    """After phase 2 has begun, a phase-1 step (``feat_frozen``) leaves
    the features and their moments alone and still steps the rest."""
    from gscream_tpu.model.scaffold import ScaffoldConfig as JCfg
    from gscream_tpu_torch.cameras import make_camera
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig
    from gscream_tpu_torch.train.state import train_state_from_numpy
    from gscream_tpu_torch.train.step import train_step
    cfg = ScaffoldConfig(**KW)
    ts = train_state_from_numpy(_start_state(JCfg(**KW)), cfg, device="cpu")
    feat0 = ts.scaffold.params.feat.clone()
    m0, v0 = ts.m["params/feat"].clone(), ts.v["params/feat"].clone()
    off0 = ts.scaffold.params.offset.clone()
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 1.0,
                      1.0 * H / W, W, H, device="cpu")
    gt, mask, midas, fg_box = _targets()
    ts, aux = train_step(ts, cam, to_torch(gt), to_torch(mask),
                         to_torch(midas), to_torch(fg_box), cfg=cfg,
                         opt=OptimConfig(), is_ref=False, capacity=CAP,
                         width=W, height=H, accumulate=True,
                         feat_frozen=True)
    assert torch.equal(ts.scaffold.params.feat, feat0)
    assert torch.equal(ts.m["params/feat"], m0)
    assert torch.equal(ts.v["params/feat"], v0)
    assert not torch.equal(ts.scaffold.params.offset, off0)
