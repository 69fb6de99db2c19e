"""Densification: the port's ``adjust_anchors`` against the JAX
package's on the CPU, from one seeded state carried across, with JAX's
keep draws fed to the port (its ``keep_draw`` replaced).

The state is ``tests/test_torch_train_step.py``'s model (≈200 alive
anchors, feat_dim 8, 2 offsets) with statistics made to densify: offset
gradients spread across the three levels' thresholds, visit counts above
and below the candidate bar, anchors observed long enough with too
little opacity (pruned), and log-scales above the 0.05 cap.  Every
anchor's first offset is zero, so its candidate lands in its own voxel
and is deduplicated against it.  At capacity 1024 the survivors fit; at
capacity 208 they do not (``grow_overflow`` > 0).

``alive``, the anchors (voxel coordinates times the voxel size, one
float32 product in both), ``grow_overflow`` and every statistic are
bit-equal; the other parameters and the moments within 1 ulp (``log`` of
the voxel size and σ⁻¹(0.1) are evaluated by each package's own ``log``).
"""
import jax
import numpy as np
import pytest
import torch

from tests.test_torch_common import (  # noqa: F401
    to_torch, two_torch_threads)
from tests.test_torch_train_step import KW, _start_state

CAPACITIES = (1024, 208)
OPT = dict(check_interval=100, success_threshold=0.8, grad_threshold=2e-4,
           min_opacity=0.005)


def _state(capacity):
    """The JAX state (numpy leaves) and its configuration."""
    from gscream_tpu.model.scaffold import ScaffoldConfig as JCfg
    jcfg = JCfg(**dict(KW, capacity=capacity))
    ts = _start_state(jcfg)
    rng = np.random.default_rng(61)
    C, k = capacity, jcfg.n_offsets
    p = ts.scaffold.params
    offset = p.offset.copy()
    offset[:, 0] = 0.0
    scaling = p.scaling.copy()
    scaling[:, 3:] = rng.uniform(-0.5, 0.5, (C, 3)).astype(np.float32)
    denom = rng.integers(0, 100, (C, k)).astype(np.float32)
    grad = (denom * 10.0 ** rng.uniform(-5, -2.5, (C, k))).astype(np.float32)
    demon = rng.integers(0, 100, (C, 1)).astype(np.float32)
    op_acc = (demon * np.where(rng.uniform(size=(C, 1)) < 0.2, 1e-3,
                               0.3)).astype(np.float32)
    stats = ts.stats._replace(
        opacity_accum=op_acc, anchor_demon=demon, offset_grad_accum=grad,
        offset_denom=denom, grow_overflow=np.int32(3))
    rnd = lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32)  # noqa
    m = jax.tree.map(rnd, ts.m)
    v = jax.tree.map(lambda a: np.abs(rnd(a)), ts.v)
    ts = ts._replace(scaffold=ts.scaffold._replace(params=p._replace(
        offset=offset, scaling=scaling)), stats=stats, m=m, v=v)
    return jcfg, ts


def _keys(key, depth):
    """JAX's per-level keep draws' keys (densify.py:132-133)."""
    subs = []
    for _ in range(depth):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


@pytest.fixture(scope="module")
def results():
    from gscream_tpu.model.densify import adjust_anchors as jadjust
    from gscream_tpu_torch.model import densify
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig
    from gscream_tpu_torch.train.state import train_state_from_numpy
    out = {}
    saved = densify.keep_draw
    try:
        for cap in CAPACITIES:
            jcfg, jts = _state(cap)
            key = jax.random.fold_in(jax.random.PRNGKey(11), cap)
            sc, st, (m0, v0) = jadjust(jts.scaffold, jts.stats,
                                       (jts.m[0], jts.v[0]), key, jcfg, **OPT)
            jres = jax.tree.map(np.asarray, jts._replace(
                scaffold=sc, stats=st, m=(m0, jts.m[1]), v=(v0, jts.v[1])))
            cfg = ScaffoldConfig(**dict(KW, capacity=cap))
            draws = [to_torch(jax.random.uniform(s, (cap * cfg.n_offsets,)))
                     for s in _keys(key, cfg.update_depth)]
            densify.keep_draw = lambda gen, n, level, dev: draws[level]
            ts = train_state_from_numpy(jts, cfg, device="cpu")
            psc, pst, pm, pv = densify.adjust_anchors(
                ts.scaffold, ts.stats, ts.m, ts.v, None, cfg, **OPT)
            out[cap] = dict(
                jax=train_state_from_numpy(jres, cfg, device="cpu"),
                port=ts._replace(scaffold=psc, stats=pst, m=pm, v=pv),
                start=train_state_from_numpy(jts, cfg, device="cpu"))
    finally:
        densify.keep_draw = saved
    return out


@pytest.mark.timeout(120)
@pytest.mark.parametrize("cap", CAPACITIES)
def test_alive_anchors_and_stats_bit_equal(results, cap):
    r = results[cap]
    pj, pt, p0 = r["jax"].scaffold, r["port"].scaffold, r["start"].scaffold
    assert torch.equal(pt.alive, pj.alive)
    assert torch.equal(pt.params.anchor, pj.params.anchor)
    for f in pt.params._fields:      # untouched where no slot was born
        born = pj.alive & ~p0.alive
        assert torch.equal(getattr(pt.params, f)[~born & ~p0.alive],
                           getattr(pj.params, f)[~born & ~p0.alive]), f
    for f, got, want in zip(r["jax"].stats._fields, r["port"].stats,
                            r["jax"].stats):
        assert got.dtype == want.dtype, f
        assert torch.equal(got, want), f
    born = int((pj.alive & ~p0.alive).sum())
    pruned = int((p0.alive & ~pj.alive).sum())
    overflow = int(r["jax"].stats.grow_overflow) - 3
    print(f"capacity {cap}: {born} born, {pruned} pruned, overflow "
          f"{overflow}")
    assert born > 0 and pruned > 0
    if cap == 208:
        assert overflow > 0 and not bool((~pj.alive).sum() > pruned)
    else:
        assert overflow == 0


@pytest.mark.timeout(120)
@pytest.mark.parametrize("cap", CAPACITIES)
def test_params_and_moments_within_an_ulp(results, cap):
    from gscream_tpu_torch.train.state import named_params
    r = results[cap]
    pj = named_params(r["jax"].scaffold)
    pt = named_params(r["port"].scaffold)
    for name in pj:
        np.testing.assert_array_max_ulp(pt[name].detach().numpy(),
                                        pj[name].detach().numpy(), 1)
        for mo in ("m", "v"):
            np.testing.assert_array_max_ulp(
                getattr(r["port"], mo)[name].numpy(),
                getattr(r["jax"], mo)[name].numpy(), 1)
    assert float(r["port"].scaffold.params.scaling[:, 3:].max()) <= \
        np.float32(0.05)


def test_dedup_against_alive_anchors():
    """One candidate in an alive anchor's voxel and one in an empty voxel
    (keep draws all 1): only the second is born, with its voxel's
    coordinates, zeroed moments and the newborn defaults."""
    from gscream_tpu_torch.model import densify
    from gscream_tpu_torch.model.scaffold import (ScaffoldConfig,
                                                  init_scaffold)
    from gscream_tpu_torch.train.state import init_train_state
    cfg = ScaffoldConfig(feat_dim=4, n_offsets=2, voxel_size=0.01,
                         capacity=8, update_depth=1)
    pts = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], np.float32)
    st = init_scaffold(pts, cfg, torch.Generator().manual_seed(0),
                       device="cpu")
    off = torch.zeros_like(st.params.offset)
    off[0, 1] = torch.tensor([0.3, 0.0, 0.0]) / torch.exp(
        st.params.scaling[0, :3])          # 0.3 away: an empty voxel
    st = st._replace(params=st.params._replace(
        offset=off, feat=torch.arange(32.0).reshape(8, 4)))
    ts = init_train_state(st, cfg)
    ts.m["params/feat"].fill_(1.0)
    stats = ts.stats._replace(
        offset_denom=torch.full((8, 2), 50.0),
        offset_grad_accum=torch.full((8, 2), 50.0))
    saved = densify.keep_draw
    densify.keep_draw = lambda gen, n, level, dev: torch.ones(n)
    try:
        sc, st2, m, _ = densify.adjust_anchors(ts.scaffold, stats, ts.m,
                                               ts.v, None, cfg)
    finally:
        densify.keep_draw = saved
    size = cfg.voxel_size * cfg.update_init_factor
    assert sc.alive.tolist() == [True, True, True] + [False] * 5
    want = torch.round(torch.tensor([0.3, 0.0, 0.0]) / size) * size
    assert torch.equal(sc.params.anchor[2], want)
    assert torch.equal(sc.params.feat[2], st.params.feat[0])
    assert not m["params/feat"][2].any() and m["params/feat"][0].all()
    assert torch.equal(sc.params.rotation[2], torch.tensor([1.0, 0, 0, 0]))
    assert not sc.params.offset[2].any()
    assert int(st2.grow_overflow) == 0
