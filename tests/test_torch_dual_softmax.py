"""The two softmaxes of the cross-attention's shared similarity
(``gscream_tpu_torch/ops/attention.py::dual_softmax``).

On the CPU, where the wrappers take their plain versions: the forward
twin (the lines of ``bidirectional_attn`` the kernels replaced) against
both softmaxes written out in float64; the backward twin's closed form
matches autograd through the forward twin to rtol 1e-5;
``bidirectional_attn`` through the ``torch.autograd.Function`` gives the
outputs of autograd through the forward twin bit for bit and its
gradients within rtol 1e-5; the launch counters stay 0.  Each check runs without
masks, with partial masks, with the context masked everywhere (every row
of ``attn`` masked: uniform) and with the sequence masked everywhere
(every column of ``ctx_attn`` masked: uniform), at N ≠ M.

On the card (``requires_cuda``): both kernels against their plain
versions at the benchmark's (8, 2000, 2000) with its prefix masks, at a
ragged (3, 37, 1001) (the scalar path) and at (2, 36, 1028) (16-byte
vectors, tiles cut at both edges), with fully masked rows and columns,
within ``KERNEL_RTOL`` and ``KERNEL_ATOL`` of ``ops/attention.py``; a
rerun is bit-equal; the counters
rise once per forward and once per backward.  This file imports neither JAX nor
the JAX package: on a machine with a card, ``python -m pytest
--noconftest -p no:cacheprovider tests/test_torch_dual_softmax.py``.
"""
import numpy as np
import pytest
import torch

from gscream_tpu_torch.ops import attention as at

# one intra-op thread, as tests/test_torch_common.py sets for the other
# port tests (several test processes share the cores)
torch.set_num_threads(1)

CPU_SHAPES = [(2, 7, 5), (8, 64, 48)]
SCALE = 64 ** -0.5
RTOL = 1e-5
# measured at (8, 2000, 2000) with the prefix masks on an H100: beyond
# KERNEL_RTOL, 0 (attn, ctx_attn) and 2.4e-8 of the largest (the gradient)
CARD_RTOL, CARD_ATOL = at.KERNEL_RTOL, at.KERNEL_ATOL


def _cases(n, m, rng, device="cpu"):
    mask = torch.as_tensor(rng.uniform(size=n) < 0.6, device=device)
    cmask = torch.as_tensor(rng.uniform(size=m) < 0.6, device=device)
    mask[0] = cmask[0] = True
    cmask[-1] = False
    return {"none": (None, None), "partial": (mask, cmask),
            "rows_masked": (mask, torch.zeros_like(cmask)),
            "columns_masked": (torch.zeros_like(mask), cmask)}


def _inputs(shape, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    h, n, m = shape
    sim = torch.randn(shape, generator=g) * 4.0
    g_attn = torch.randn(shape, generator=g)
    # the layout autograd hands from the output einsum: (h, M, N) storage
    g_ctx = torch.randn((h, m, n), generator=g).transpose(1, 2)
    return sim.to(device), g_attn.to(device), g_ctx.to(device)


def _softmax64(s, dim):
    e = torch.exp(s - s.max(dim, keepdim=True).values)
    return e / e.sum(dim, keepdim=True)


@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_forward_twin_is_both_softmaxes(shape):
    """Each output against its definition in float64: masked positions
    take finfo(float32).min, so a row or column masked everywhere comes out
    uniform and every other masked position 0."""
    sim, _, _ = _inputs(shape, 1)
    h, n, m = shape
    low = float(torch.finfo(torch.float32).min)
    for name, (mask, cmask) in _cases(n, m, np.random.default_rng(2)
                                      ).items():
        cm = torch.ones(m, dtype=torch.bool) if cmask is None else cmask
        mi = torch.ones(n, dtype=torch.bool) if mask is None else mask
        s = torch.where(cm, sim.double() * SCALE, low)
        want = (_softmax64(s, -1),
                _softmax64(torch.where(mi[:, None], s, low), -2))
        got = at.dual_softmax_plain(sim, SCALE, mask, cmask)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.double(), w, rtol=RTOL, atol=1e-7,
                                       msg=name)
        if cm.any():
            assert not got[0][:, :, ~cm].any(), name
        else:
            assert torch.equal(got[0], torch.full_like(got[0], 1 / m)), name
        if mi.any() and cm.any():
            assert not got[1][:, ~mi][:, :, cm].any(), name
        if not mi.any():
            assert torch.equal(got[1], torch.full_like(got[1], 1 / n)), name


@pytest.mark.parametrize("shape", CPU_SHAPES)
def test_backward_twin_matches_autograd(shape):
    sim, g_attn, g_ctx = _inputs(shape, 3)
    for name, (mask, cmask) in _cases(*shape[1:], np.random.default_rng(4)
                                      ).items():
        raw = sim.clone().requires_grad_()
        attn, ctx_attn = at.dual_softmax_plain(raw, SCALE, mask, cmask)
        (ref,) = torch.autograd.grad((attn, ctx_attn), raw, (g_attn, g_ctx))
        got = at.dual_softmax_bwd_plain(attn.detach(), ctx_attn.detach(),
                                        g_attn, g_ctx, SCALE, mask, cmask)
        torch.testing.assert_close(got, ref, rtol=RTOL,
                                   atol=RTOL * float(ref.abs().max()),
                                   msg=name)
        if cmask is not None:
            assert not got[:, :, ~cmask].any(), name


def test_attention_through_the_function_matches_replaced_code(monkeypatch):
    """``bidirectional_attn`` with the Function against the same call with
    ``dual_softmax`` replaced by autograd through the forward twin."""
    dim, heads, dim_head, n, m = 8, 4, 8, 24, 20
    rng = np.random.default_rng(5)
    shapes = at.attn_shapes(dim, heads, dim_head)
    p = {f: torch.as_tensor(rng.uniform(-0.4, 0.4, shapes[f]),
                            dtype=torch.float32) for f in at.FIELDS}
    x = torch.as_tensor(rng.normal(0, 0.5, (n, dim)), dtype=torch.float32)
    c = torch.as_tensor(rng.normal(0, 0.5, (m, dim)), dtype=torch.float32)
    cot = (torch.as_tensor(rng.normal(size=(n, dim)), dtype=torch.float32),
           torch.as_tensor(rng.normal(size=(m, dim)), dtype=torch.float32))

    def run(mask, cmask):
        leaves = [t.clone().requires_grad_() for t in (*p.values(), x, c)]
        arrays = dict(zip(p, leaves))
        out = at.bidirectional_attn(arrays, leaves[-2], leaves[-1], heads,
                                    dim_head, mask=mask, context_mask=cmask)
        grads = torch.autograd.grad(out, leaves, cot)
        return [o.detach() for o in out], grads

    for name, (mask, cmask) in _cases(n, m, np.random.default_rng(6)).items():
        got_out, got = run(mask, cmask)
        with monkeypatch.context() as mp:
            mp.setattr(at, "dual_softmax", at.dual_softmax_plain)
            ref_out, ref = run(mask, cmask)
        for g, r in zip(got_out, ref_out):
            assert torch.equal(g, r), name
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=RTOL,
                                       atol=RTOL * float(r.abs().max()),
                                       msg=name)


def test_launch_counters_stay_zero_on_the_cpu():
    before = (at.dual_softmax_fwd.launches, at.dual_softmax_bwd.launches)
    sim, g_attn, g_ctx = _inputs((2, 7, 5), 7)
    raw = sim.clone().requires_grad_()
    attn, ctx_attn = at.dual_softmax(raw, SCALE)
    torch.autograd.grad((attn, ctx_attn), raw, (g_attn, g_ctx))
    assert (at.dual_softmax_fwd.launches,
            at.dual_softmax_bwd.launches) == before
    if not torch.cuda.is_available():
        assert before == (0, 0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card_cases(shape, dev):
    h, n, m = shape
    if shape == (8, 2000, 2000):
        # the benchmark's tokens: both sides valid on the same prefix
        # (rank < min(n_fg, n_bg, 2000))
        valid = torch.arange(2000, device=dev) < 1733
        return {"none": (None, None), "prefix": (valid, valid),
                "rows_masked": (valid, torch.zeros_like(valid))}
    return _cases(n, m, np.random.default_rng(8), dev)


def _assert_within(got, ref, rtol, atol_share, name):
    atol = atol_share * float(ref.abs().max())
    err = (got - ref).abs()
    worst = float((err - rtol * ref.abs()).max())
    assert torch.isfinite(got).all(), name
    assert worst <= atol, (f"{name}: worst {float(err.max()):.3e} beyond "
                           f"rtol {rtol} by {worst:.3e} > {atol:.3e}")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape", [(8, 2000, 2000), (3, 37, 1001),
                                   (2, 36, 1028)])
def test_kernels_match_plain_versions(dev, shape):
    sim, g_attn, g_ctx = _inputs(shape, 9, dev)
    for name, (mask, cmask) in _card_cases(shape, dev).items():
        attn, ctx_attn = at.dual_softmax_fwd(sim, SCALE, mask, cmask)
        p_attn, p_ctx = at.dual_softmax_plain(sim, SCALE, mask, cmask)
        _assert_within(attn, p_attn, CARD_RTOL, CARD_ATOL, f"{name} attn")
        _assert_within(ctx_attn, p_ctx, CARD_RTOL, CARD_ATOL, f"{name} ctx")
        again = at.dual_softmax_fwd(sim, SCALE, mask, cmask)
        assert torch.equal(again[0], attn) and torch.equal(again[1], ctx_attn)
        grad = at.dual_softmax_bwd(attn, ctx_attn, g_attn, g_ctx, SCALE,
                                   mask, cmask)
        plain = at.dual_softmax_bwd_plain(attn, ctx_attn, g_attn, g_ctx,
                                          SCALE, mask, cmask)
        _assert_within(grad, plain, CARD_RTOL, CARD_ATOL, f"{name} grad")
        assert torch.equal(grad, at.dual_softmax_bwd(
            attn, ctx_attn, g_attn, g_ctx, SCALE, mask, cmask))
        # a gradient of ctx_attn in the (h, N, M) layout is copied first
        natural = at.dual_softmax_bwd(attn, ctx_attn, g_attn,
                                      g_ctx.contiguous(), SCALE, mask, cmask)
        assert torch.equal(natural, grad), name
    torch.cuda.synchronize()


@pytest.mark.requires_cuda
def test_launch_counters_rise_on_the_card(dev):
    sim, g_attn, g_ctx = _inputs((2, 36, 1028), 10, dev)
    before = (at.dual_softmax_fwd.launches, at.dual_softmax_bwd.launches)
    raw = sim.clone().requires_grad_()
    attn, ctx_attn = at.dual_softmax(raw, SCALE)
    assert (at.dual_softmax_fwd.launches - before[0],
            at.dual_softmax_bwd.launches - before[1]) == (1, 0)
    torch.autograd.grad((attn, ctx_attn), raw, (g_attn, g_ctx))
    assert (at.dual_softmax_fwd.launches - before[0],
            at.dual_softmax_bwd.launches - before[1]) == (1, 1)
