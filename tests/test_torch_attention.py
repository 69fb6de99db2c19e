"""Phase 2's bidirectional cross-attention: the port's
``ops/attention.py`` against the JAX package's on the CPU.

One seeded set of arrays and tokens (dim 8, 4 heads of 8, 24 sequence
and 20 context tokens) goes through both packages without masks, with
partial masks, and with the context masked everywhere (every row of the
similarity masked: both softmaxes come out uniform, not NaN).  Outputs
and the gradients of a fixed scalar of both outputs with respect to the
eight arrays and the tokens are held at rtol 1e-5, atol 1e-6 (the
matmuls sum in other orders).  The JAX reference is one ``jax.jit``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_common import (  # noqa: F401
    to_torch, two_torch_threads)

DIM, HEADS, DIM_HEAD, N, M = 8, 4, 8, 24, 20
RTOL, ATOL = 1e-5, 1e-6


def _inputs():
    from gscream_tpu_torch.ops.attention import FIELDS, attn_shapes
    rng = np.random.default_rng(31)
    shapes = attn_shapes(DIM, HEADS, DIM_HEAD)
    p = {f: rng.uniform(-0.4, 0.4, shapes[f]).astype(np.float32)
         for f in FIELDS}
    x = rng.normal(0, 0.5, (N, DIM)).astype(np.float32)
    c = rng.normal(0, 0.5, (M, DIM)).astype(np.float32)
    mask = rng.uniform(size=N) < 0.7
    cmask = rng.uniform(size=M) < 0.6
    cot = (rng.normal(size=(N, DIM)).astype(np.float32),
           rng.normal(size=(M, DIM)).astype(np.float32))
    cases = {"none": (None, None), "partial": (mask, cmask),
             "context_all_masked": (mask, np.zeros(M, bool))}
    return p, x, c, cases, cot


@pytest.fixture(scope="module")
def results():
    from gscream_tpu.ops.attention import BidirAttnParams, bidirectional_attn
    from gscream_tpu_torch.ops.attention import FIELDS
    from gscream_tpu_torch.ops.attention import \
        bidirectional_attn as port_attn
    p, x, c, cases, cot = _inputs()

    def objective(attn, arrays, xx, cc, m, cm, co):
        out, ctx = attn(arrays, xx, cc, m, cm)
        return (out * co[0]).sum() + (ctx * co[1]).sum(), (out, ctx)

    @jax.jit
    def reference(arrays, xx, cc):
        out = {}
        for name, (m, cm) in cases.items():
            def f(a, xx_, cc_):
                prm = BidirAttnParams(*(a[k] for k in FIELDS), heads=HEADS,
                                      dim_head=DIM_HEAD)
                return objective(
                    lambda q, u, w, mm, cmm: bidirectional_attn(
                        q, u, w, mask=mm, context_mask=cmm),
                    prm, xx_, cc_,
                    None if m is None else jnp.asarray(m),
                    None if cm is None else jnp.asarray(cm),
                    tuple(jnp.asarray(t) for t in cot))
            (_, outs), grads = jax.value_and_grad(
                f, argnums=(0, 1, 2), has_aux=True)(arrays, xx, cc)
            out[name] = (outs, grads)
        return out

    ref = jax.tree.map(np.asarray, reference(p, x, c))
    port = {}
    for name, (m, cm) in cases.items():
        arrays = {k: to_torch(v).requires_grad_() for k, v in p.items()}
        xx, cc = to_torch(x).requires_grad_(), to_torch(c).requires_grad_()
        val, outs = objective(
            lambda q, u, w, mm, cmm: port_attn(q, u, w, HEADS, DIM_HEAD,
                                               mask=mm, context_mask=cmm),
            arrays, xx, cc, None if m is None else to_torch(m),
            None if cm is None else to_torch(cm),
            tuple(to_torch(t) for t in cot))
        gx = torch.autograd.grad(val, [arrays[k] for k in FIELDS] + [xx, cc])
        port[name] = (tuple(o.detach().numpy() for o in outs),
                      ({k: g.numpy() for k, g in zip(FIELDS, gx[:8])},
                       gx[8].numpy(), gx[9].numpy()))
    return ref, port


@pytest.mark.parametrize("case", ["none", "partial", "context_all_masked"])
def test_outputs_match(results, case):
    ref, port = results
    for got, want, what in zip(port[case][0], ref[case][0],
                               ("out", "ctx_out")):
        assert np.isfinite(got).all(), what
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{case} {what}")


@pytest.mark.parametrize("case", ["none", "partial", "context_all_masked"])
def test_gradients_match(results, case):
    ref, port = results
    g_arrays, g_x, g_c = port[case][1]
    r_arrays, r_x, r_c = ref[case][1]
    for k, g in g_arrays.items():
        np.testing.assert_allclose(g, r_arrays[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{case} d/d{k}")
    np.testing.assert_allclose(g_x, r_x, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g_c, r_c, rtol=RTOL, atol=ATOL)


def test_fully_masked_rows_are_uniform(results):
    """With the context masked everywhere, every sequence row averages
    the context values uniformly, as JAX's softmax over finfo.min does."""
    from gscream_tpu_torch.ops.attention import bidirectional_attn
    p, x, c, cases, _ = _inputs()
    arrays = {k: to_torch(v) for k, v in p.items()}
    out, _ = bidirectional_attn(arrays, to_torch(x), to_torch(c), HEADS,
                                DIM_HEAD,
                                context_mask=torch.zeros(M, dtype=bool))
    cv = to_torch(c) @ arrays["ctx_to_v"]
    want = cv.mean(0) @ arrays["to_out_w"] + arrays["to_out_b"]
    np.testing.assert_allclose(out.numpy(), np.broadcast_to(
        want.numpy(), out.shape), rtol=1e-5, atol=1e-6)


def test_init_shapes_and_bounds():
    """``init_bidirectional_attn`` makes JAX's shapes, U(±1/√fan_in)
    weights and zero biases; the scaffold's decoders carry the same
    draws."""
    from gscream_tpu.ops.attention import init_bidirectional_attn as jinit
    from gscream_tpu_torch.model.scaffold import ScaffoldConfig, init_mlps
    from gscream_tpu_torch.ops.attention import (FIELDS,
                                                 init_bidirectional_attn)
    jp = jinit(jax.random.PRNGKey(0), dim=DIM, heads=HEADS,
               dim_head=DIM_HEAD)
    tp = init_bidirectional_attn(torch.Generator().manual_seed(0), DIM,
                                 HEADS, DIM_HEAD)
    assert tuple(tp) == FIELDS
    for k, jarr in zip(FIELDS, jp[:8]):
        t = tp[k]
        assert tuple(t.shape) == tuple(jarr.shape), k
        if k.endswith("_b"):
            assert not t.any(), k
        else:
            bound = 1.0 / np.sqrt(t.shape[0])
            assert float(t.abs().max()) <= bound, k
            assert float(t.abs().max()) > 0.5 * bound, k
    cfg = ScaffoldConfig(feat_dim=DIM, n_offsets=2, capacity=16,
                         attn_heads=HEADS, attn_head_dim=DIM_HEAD)
    mlps = init_mlps(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(float(t.abs().max()) > 0 for n, t in mlps.crossattn.arrays()
               if not n.endswith("_b"))
