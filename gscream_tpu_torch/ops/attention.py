"""Bidirectional cross-attention (counterpart of
``gscream_tpu/ops/attention.py``).

The ``BidirectionalCrossAttention(dim=32, heads=8, dim_head=64,
context_dim=32)`` module the reference instantiates at
``scene/gaussian_model.py:161-167`` and drives from ``run_crossattn``
(gaussian_model.py:553-583): foreground anchor features attend to
background anchor features and back through one *shared* similarity
matrix, softmax over the context axis for the sequence output and over
the sequence axis for the context output.  With the reference's
constructor defaults (no pre-norm, no dropout, no talking heads):

    qk, v   = x Wqk,  x Wv              (no bias)
    cqk, cv = c Wcqk, c Wcv             (no bias)
    sim     = qk cqkᵀ · scale           (per head)
    out     = softmax_j(sim) cv Wo + bo
    ctx_out = softmax_i(sim)ᵀ v Wco + bco

The parameters are the eight arrays of ``ScaffoldMLPs.crossattn`` in the
JAX layout (``(fan_in, fan_out)`` weights), passed as a mapping from
their names.  The products stay ``torch.matmul``/``einsum`` in full
float32.  The two softmaxes over the shared ``sim``, with its scale and
both masks, are one ``torch.autograd.Function`` (``dual_softmax``) whose
forward and backward are hand-written kernels on the card
(``csrc/attention.cu``): PyTorch takes the context-side softmax, over dim
-2 of the row-major (h, N, M) ``sim``, with a strided kernel some 20×
off its byte bound, and runs the scale, the masks, their backwards and the
add of the two gradients as full passes of their own.  The JAX package
leaves all of this to XLA, so the kernels replace no Pallas kernel.  CPU
tensors take the plain versions, ``dual_softmax_plain`` (the lines the
kernels replaced) and ``dual_softmax_bwd_plain`` (the closed form of
their gradient).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Mapping

import numpy as np
import torch

from . import cuda_build as cb

# the arrays in the order of the JAX package's ``BidirAttnParams``
FIELDS = ("to_qk", "ctx_to_qk", "to_v", "ctx_to_v", "to_out_w", "to_out_b",
          "ctx_out_w", "ctx_out_b")


def attn_shapes(dim: int, heads: int, dim_head: int):
    """{name: shape} of the eight arrays (the context's width is ``dim``,
    as the reference instantiates the module)."""
    inner = heads * dim_head
    return {"to_qk": (dim, inner), "ctx_to_qk": (dim, inner),
            "to_v": (dim, inner), "ctx_to_v": (dim, inner),
            "to_out_w": (inner, dim), "to_out_b": (dim,),
            "ctx_out_w": (inner, dim), "ctx_out_b": (dim,)}


def init_bidirectional_attn(generator: torch.Generator, dim=32, heads=8,
                            dim_head=64) -> Dict[str, torch.Tensor]:
    """``nn.Linear``'s default init, U(±1/√fan_in), for the six weights
    (drawn in field order from ``generator``), zero biases; CPU tensors.
    The JAX package draws the same distribution from ``jax.random``; the
    two streams differ."""
    out = {}
    for name, shape in attn_shapes(dim, heads, dim_head).items():
        if name.endswith("_b"):
            out[name] = torch.zeros(shape)
        else:
            bound = 1.0 / np.sqrt(shape[0])
            out[name] = torch.empty(shape).uniform_(-bound, bound,
                                                    generator=generator)
    return out


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    n, inner = x.shape
    return x.reshape(n, heads, inner // heads).transpose(0, 1)   # (h,n,d)


def dual_softmax_plain(sim_raw: torch.Tensor, scale: float, mask=None,
                       context_mask=None):
    """Plain version of the forward kernel: (attn, ctx_attn), the softmax
    of the scaled, masked ``sim_raw`` (h, N, M) over the context axis j
    and, with the rows of ``mask`` masked too, over the sequence axis i."""
    sim = sim_raw * scale
    neg = torch.finfo(sim.dtype).min
    if context_mask is not None:
        sim = torch.where(context_mask[None, None, :], sim, neg)
    sim_i = sim
    if mask is not None:
        sim_i = torch.where(mask[None, :, None], sim, neg)
    return torch.softmax(sim, dim=-1), torch.softmax(sim_i, dim=-2)


def dual_softmax_bwd_plain(attn, ctx_attn, g_attn, g_ctx, scale: float,
                           mask=None, context_mask=None):
    """Plain version of the backward kernel: the gradient of ``sim_raw``
    from those of both outputs, ``scale · cm_j · (A⊙(gA − r_i) + m_i ·
    C⊙(gC − c_j))`` with ``r_i = Σ_j gA⊙A`` and ``c_j = Σ_i gC⊙C``."""
    r = (g_attn * attn).sum(-1, keepdim=True)
    c = (g_ctx * ctx_attn).sum(-2, keepdim=True)
    g_ctx_side = ctx_attn * (g_ctx - c)
    if mask is not None:
        g_ctx_side = torch.where(mask[None, :, None], g_ctx_side, 0.0)
    g = attn * (g_attn - r) + g_ctx_side
    if context_mask is not None:
        g = torch.where(context_mask[None, None, :], g, 0.0)
    return g * scale


# The kernels against their plain versions on the card: each element of
# attn, ctx_attn and the gradient within KERNEL_RTOL of the plain one plus
# KERNEL_ATOL of the largest plain element (the sums run in other orders,
# expf and PyTorch's exp differ in the last ulp, and the probabilities are
# multiplied by a reciprocal of the sum).
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-7


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _scratch(backward: bool, h: int, n: int, m: int, device):
    """(the float32 scratch a launch needs, as ``attention.cu`` sizes it
    for this card, the card's multiprocessor count)."""
    sms = _sm_count(device)
    size = cb.function("attention", "gs_dual_softmax_scratch", "iiiii")(
        int(backward), h, n, m, sms)
    return torch.empty(size, dtype=torch.float32, device=device), sms


def _vec(n: int, m: int, *tensors) -> int:
    """1 where the kernels may move 16-byte vectors: N and M multiples of
    4, every array 16-byte aligned."""
    return int(n % 4 == 0 and m % 4 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _mask_ptr(t, name: str, size: int):
    if t is None:
        return ctypes.c_void_p(None)
    cb.check(t, name, torch.bool, (size,))
    return cb.ptr(t)


def dual_softmax_fwd(sim_raw: torch.Tensor, scale: float, mask=None,
                     context_mask=None):
    """Forward kernel: ``sim_raw`` (h, N, M) float32 → (attn, ctx_attn),
    both (h, N, M) and contiguous; the masks are (N,) and (M,) bool or
    None."""
    if sim_raw.device.type == "cpu":
        return dual_softmax_plain(sim_raw, scale, mask, context_mask)
    cb.check(sim_raw, "sim_raw", torch.float32, (None, None, None))
    h, n, m = sim_raw.shape
    mp = _mask_ptr(mask, "mask", n)
    cmp_ = _mask_ptr(context_mask, "context_mask", m)
    scratch, sms = _scratch(False, h, n, m, sim_raw.device)
    attn = torch.empty_like(sim_raw)
    ctx_attn = torch.empty_like(sim_raw)
    fn = cb.function("attention", "gs_dual_softmax_fwd", "pppiiifiipppp")
    cb.raise_on_error(fn(
        cb.ptr(sim_raw), mp, cmp_, h, n, m, scale, sms,
        _vec(n, m, sim_raw, scratch, attn, ctx_attn), cb.ptr(scratch),
        cb.ptr(attn), cb.ptr(ctx_attn), cb.stream_of(sim_raw)),
        "dual_softmax_fwd")
    dual_softmax_fwd.launches += 1
    return attn, ctx_attn


dual_softmax_fwd.launches = 0


def dual_softmax_bwd(attn, ctx_attn, g_attn, g_ctx, scale: float, mask=None,
                     context_mask=None):
    """Backward kernel: the gradient of ``sim_raw`` (h, N, M).  ``g_ctx``
    is read in the layout autograd hands it from the output einsum, the
    transpose of a contiguous (h, M, N) array; any other layout is copied
    into it first."""
    if attn.device.type == "cpu":
        return dual_softmax_bwd_plain(attn, ctx_attn, g_attn, g_ctx, scale,
                                      mask, context_mask)
    h, n, m = attn.shape
    g_ctx_t = g_ctx.transpose(1, 2).contiguous()   # a view when it can be
    g_attn = g_attn.contiguous()
    for t, name in ((attn, "attn"), (ctx_attn, "ctx_attn"),
                    (g_attn, "g_attn")):
        cb.check(t, name, torch.float32, (h, n, m))
    cb.check(g_ctx_t, "g_ctx", torch.float32, (h, m, n))
    mp = _mask_ptr(mask, "mask", n)
    cmp_ = _mask_ptr(context_mask, "context_mask", m)
    scratch, _ = _scratch(True, h, n, m, attn.device)
    out = torch.empty_like(attn)
    fn = cb.function("attention", "gs_dual_softmax_bwd", "ppppppiiifippp")
    cb.raise_on_error(fn(
        cb.ptr(attn), cb.ptr(ctx_attn), cb.ptr(g_attn), cb.ptr(g_ctx_t), mp,
        cmp_, h, n, m, scale,
        _vec(n, m, attn, ctx_attn, g_attn, g_ctx_t, scratch, out),
        cb.ptr(scratch), cb.ptr(out), cb.stream_of(attn)), "dual_softmax_bwd")
    dual_softmax_bwd.launches += 1
    return out


dual_softmax_bwd.launches = 0


class _DualSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sim_raw, scale, mask, context_mask):
        attn, ctx_attn = dual_softmax_fwd(sim_raw, scale, mask, context_mask)
        ctx.save_for_backward(attn, ctx_attn, mask, context_mask)
        ctx.scale = scale
        return attn, ctx_attn

    @staticmethod
    def backward(ctx, g_attn, g_ctx):
        attn, ctx_attn, mask, context_mask = ctx.saved_tensors
        return (dual_softmax_bwd(attn, ctx_attn, g_attn, g_ctx, ctx.scale,
                                 mask, context_mask), None, None, None)


def dual_softmax(sim_raw: torch.Tensor, scale: float, mask=None,
                 context_mask=None):
    """(attn, ctx_attn) of the unscaled similarity ``sim_raw`` (h, N, M),
    differentiable in ``sim_raw``: the kernels for CUDA tensors, the plain
    versions for CPU tensors."""
    return _DualSoftmax.apply(sim_raw, scale, mask, context_mask)


def bidirectional_attn(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                       context: torch.Tensor, heads: int, dim_head: int,
                       mask=None, context_mask=None):
    """x (N, dim), context (M, dim) → (out (N, dim), ctx_out (M, dim)).

    ``mask``/``context_mask`` are boolean validity masks; a masked
    position gets the similarity ``finfo(float32).min`` in the *other*
    side's softmax, as in the JAX package (not ``-inf``: a row masked
    everywhere then comes out as the uniform average, as JAX's does, and
    not as NaN).  The two softmaxes read one ``sim``."""
    scale = dim_head ** -0.5
    qk = _split_heads(x @ p["to_qk"], heads)              # (h,N,d)
    cqk = _split_heads(context @ p["ctx_to_qk"], heads)   # (h,M,d)
    v = _split_heads(x @ p["to_v"], heads)
    cv = _split_heads(context @ p["ctx_to_v"], heads)

    sim = torch.einsum("hid,hjd->hij", qk, cqk)           # (h,N,M), unscaled
    # attn: x attends context (over j); ctx_attn: context attends x (over i)
    attn, ctx_attn = dual_softmax(sim, scale, mask, context_mask)

    out = torch.einsum("hij,hjd->hid", attn, cv)          # (h,N,d)
    ctx_out = torch.einsum("hij,hid->hjd", ctx_attn, v)   # (h,M,d)

    out = out.transpose(0, 1).reshape(x.shape[0], -1)
    ctx_out = ctx_out.transpose(0, 1).reshape(context.shape[0], -1)
    return (out @ p["to_out_w"] + p["to_out_b"],
            ctx_out @ p["ctx_out_w"] + p["ctx_out_b"])
