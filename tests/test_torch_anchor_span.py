"""The training step over the anchor span (``train.state.anchor_span``),
on the CPU, without JAX, through both entry points: ``train_step`` and
the mesh's step (``make_sharded_train_step``) at ``Mesh()`` (1, 1) in
this process, on one view.

The state: a seeded model of 1,500 alive anchors in 4,096 slots (span
2,048), one slot inside the prefix pruned with its moments kept, random
``params/*`` moments and statistics on the first 1,500 slots, random
decoder moments.  Each case runs one step from a copy of that state
three times: at the state's span, over every slot (``span = C``, the
step as it was before the span) and one tier below the span (1,024 rows
lower, the grid's step at this size):

* ``phase1``: the reference view, densification statistics gathered;
* ``phase2``: the reference view with cross-attention (256 tokens, a
  patch over the whole image, the object mask's box), statistics off;
* ``moment``: ``phase1`` with a dead slot at 3,000, above every alive
  slot, that holds a nonzero ``params/offset`` moment: it pulls the span
  to 3,072.

At the span, against every slot: the ``params/*`` parameters and
moments, the statistics, ``step_c``, the valid tokens and the step's
scalars bit for bit; the decoder and cross-attention leaves and their
moments within rtol 1e-5 of the largest element (their weight gradients
sum over the anchor rows, and a matrix product of another row count may
sum in another order).  Every row at or beyond the span is bit-equal to
the state before the step.  One tier below the span, the step differs
from the step over every slot: each case fails when the span is one
tier too low.
"""
import copy

import numpy as np
import pytest
import torch

from tests.test_torch_common import two_torch_threads  # noqa: F401

W, H = 64, 48
C, N_ALIVE, PRUNED, MOMENT_SLOT = 4096, 1500, 100, 3000
KW = dict(feat_dim=8, n_offsets=2, voxel_size=0.01, capacity=C)
CAP = 1 << 16
TIER = 1024          # the capacity tier grid's step below 2^14 slots
CASES = ("phase1", "phase2", "moment")
ENTRIES = ("train_step", "mesh")


def _state(case):
    """The seeded state of the module docstring."""
    from gscream_tpu_torch.model.scaffold import (AnchorParams,
                                                  ScaffoldConfig,
                                                  ScaffoldState, init_mlps)
    from gscream_tpu_torch.train.state import anchor_span, init_train_state
    cfg = ScaffoldConfig(**KW)
    rng = np.random.default_rng(29)
    n, k, F = N_ALIVE, cfg.n_offsets, cfg.feat_dim

    def rows(shape, lo, hi, fill=0.0):
        out = np.full((C,) + shape, fill, np.float32)
        out[:n] = rng.uniform(lo, hi, (n,) + shape)
        return torch.as_tensor(out)
    rot = np.zeros((C, 4), np.float32)
    rot[:, 0] = 1.0
    params = AnchorParams(
        anchor=rows((3,), -1.0, 1.0) * torch.tensor([1.2, 0.6, 0.3]),
        offset=rows((k, 3), -1.0, 1.0), feat=rows((F,), -1.0, 1.0),
        scaling=rows((6,), -3.5, -2.5, fill=np.log(1e-3)),
        rotation=torch.as_tensor(rot),
        opacity=torch.full((C, 1), -2.197), uncertainty=torch.full((C, 1),
                                                                   -2.197))
    alive = torch.arange(C) < n
    alive[PRUNED] = False
    sc = ScaffoldState(params=params, mlps=init_mlps(
        cfg, torch.Generator().manual_seed(3), "cpu"), alive=alive,
        xyz_max=params.anchor[:n].max(0).values)
    ts = init_train_state(sc, cfg, seed=11)
    assert ts.span == 2 * TIER
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for key in ts.m:
            for mom, lo, hi in ((ts.m, -1e-3, 1e-3), (ts.v, 0.0, 1e-6)):
                t = mom[key]
                r = lo + torch.rand(t.shape, generator=g) * (hi - lo)
                if key.startswith("params/"):
                    r[n:] = 0.0
                t.copy_(r)
        for f in ("opacity_accum", "anchor_demon", "offset_grad_accum",
                  "offset_denom"):
            t = getattr(ts.stats, f)
            t[:n] = torch.rand(t[:n].shape, generator=g) * 10
        if case == "moment":
            ts.m["params/offset"][MOMENT_SLOT] = 1e-4
    ts = ts._replace(step=7, step_c=torch.tensor(3, dtype=torch.int32),
                     span=anchor_span(ts))
    return cfg, ts


def _inputs():
    from gscream_tpu_torch.cameras import make_camera
    rng = np.random.default_rng(31)
    gt = torch.as_tensor(rng.uniform(0.2, 0.8, (3, H, W)).astype(np.float32))
    mask = torch.zeros((1, H, W))
    mask[:, H // 4:3 * H // 4, W // 3:2 * W // 3] = 1.0
    ramp = torch.linspace(0.0, 1.0, W)[None, None, :].expand(1, H, W)
    midas = (0.1 + 0.8 * ramp).contiguous()
    fg_box = torch.zeros((H, W))
    fg_box[H // 8:7 * H // 8, W // 4:3 * W // 4] = 1.0
    cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), 1.0,
                      1.0 * H / W, W, H, device="cpu")
    return cam, gt, mask, midas, fg_box


def _copy(ts):
    """A deep copy of ``ts``: its tensors, decoders and generator."""
    g = torch.Generator()
    g.set_state(ts.generator.get_state())
    return copy.deepcopy(ts._replace(generator=None))._replace(generator=g)


def _step(ts, cfg, entry, case, span):
    """One step of ``case`` through ``entry`` from a copy of ``ts`` at
    ``span``; returns (the state after, its aux values, the tokens
    drawn)."""
    from gscream_tpu_torch.config import OptimConfig
    from gscream_tpu_torch.parallel.mesh import Mesh
    from gscream_tpu_torch.parallel.shard import (make_sharded_train_step,
                                                  sharded_view_batch)
    from gscream_tpu_torch.train import step as step_mod
    cam, gt, mask, midas, fg_box = _inputs()
    box = torch.tensor([0, H, 0, W], dtype=torch.int32)
    opt = OptimConfig(crossattn_max_tokens=256)
    phase2 = case == "phase2"
    tokens = []
    inner = step_mod.sample_cross_tokens

    def spy(*a, **kw):
        tokens.append(inner(*a, **kw))
        return tokens[-1]
    step_mod.sample_cross_tokens = spy
    try:
        ts = _copy(ts)._replace(span=span)
        if entry == "mesh":
            batch = sharded_view_batch(
                [dict(camera=cam, image=gt, mask=mask, depth=midas)],
                fg_boxes=[fg_box], is_ref=[True], cross_boxes=[box],
                cross_enable=[phase2], device="cpu")
            step = make_sharded_train_step(Mesh(), cfg, opt, CAP, W, H)
            new, aux = step(ts, batch, use_crossattn=phase2,
                            accumulate=not phase2)
        else:
            new, aux = step_mod.train_step(
                ts, cam, gt, mask, midas, fg_box, box, cfg=cfg, opt=opt,
                is_ref=True, use_crossattn=phase2, capacity=CAP, width=W,
                height=H, accumulate=not phase2)
    finally:
        step_mod.sample_cross_tokens = inner
    return new, step_mod.aux_values(aux), tokens


@pytest.fixture(scope="module",
                params=[(e, c) for e in ENTRIES for c in CASES],
                ids=lambda p: "-".join(p))
def runs(request):
    """Each entry point's and case's state and its step at the span,
    over every slot and one tier below the span."""
    entry, case = request.param
    cfg, ts = _state(case)
    before = _copy(ts)
    return dict(case=case, span=ts.span, before=before,
                at_span=_step(ts, cfg, entry, case, ts.span),
                whole=_step(ts, cfg, entry, case, C),
                low=_step(ts, cfg, entry, case, ts.span - TIER))


def _differences(a, b):
    """Names of the leaves where two (state, aux, tokens) results differ:
    the per-anchor and scalar leaves bit for bit, the decoder and
    cross-attention leaves beyond rtol 1e-5 of the largest element."""
    from gscream_tpu_torch.train.state import named_params
    (sa, xa, ta), (sb, xb, tb) = a, b
    out = []
    pa, pb = named_params(sa.scaffold), named_params(sb.scaffold)
    for name in pa:
        for what, u, w in (("", pa[name], pb[name]),
                           ("m ", sa.m[name], sb.m[name]),
                           ("v ", sa.v[name], sb.v[name])):
            if name.startswith("params/"):
                same = torch.equal(u, w)
            else:
                scale = max(float(w.detach().abs().max()), 1e-30)
                same = float((u - w).detach().abs().max()) <= 1e-5 * scale
            if not same:
                out.append(what + name)
    for f in sa.stats._fields:
        if not torch.equal(getattr(sa.stats, f), getattr(sb.stats, f)):
            out.append("stats " + f)
    if not torch.equal(sa.step_c, sb.step_c) or sa.step != sb.step:
        out.append("step")
    if xa != xb:
        out.append("aux")
    for t, u in zip(ta, tb):
        for idx, valid in (("fg_idx", "fg_valid"), ("bg_idx", "bg_valid")):
            va, vb = getattr(t, valid), getattr(u, valid)
            if not (torch.equal(va, vb) and torch.equal(
                    getattr(t, idx)[va], getattr(u, idx)[vb])):
                out.append("tokens " + idx)
        if not torch.equal(t.ok, u.ok):
            out.append("tokens ok")
    return out


def test_span_follows_the_state(runs):
    """The span is the tier of one past the highest slot that is alive
    or holds a nonzero moment, and the step's flags are set."""
    assert runs["span"] == (3 * TIER if runs["case"] == "moment"
                            else 2 * TIER)
    _, aux, tokens = runs["whole"]
    assert aux[2] <= CAP and aux[3] > 0
    if runs["case"] == "phase2":
        assert aux[4] == 1.0 and int(tokens[0].fg_valid.sum()) > 11


def test_step_at_span_matches_every_slot(runs):
    assert _differences(runs["at_span"], runs["whole"]) == []


def test_rows_beyond_span_untouched(runs):
    from gscream_tpu_torch.train.state import named_params
    S, before, after = runs["span"], runs["before"], runs["at_span"][0]
    pb, pa = named_params(before.scaffold), named_params(after.scaffold)
    for name in pb:
        if not name.startswith("params/"):
            continue
        for u, w in ((pb[name], pa[name]), (before.m[name], after.m[name]),
                     (before.v[name], after.v[name])):
            assert torch.equal(u[S:], w[S:]), name
    for f in ("opacity_accum", "anchor_demon", "offset_grad_accum",
              "offset_denom"):
        assert torch.equal(getattr(before.stats, f)[S:],
                           getattr(after.stats, f)[S:]), f


def test_one_tier_lower_differs(runs):
    """The comparison sees a span one tier too low."""
    diff = _differences(runs["low"], runs["whole"])
    assert any(d.startswith("params/") or d.startswith("m params/")
               for d in diff), diff
