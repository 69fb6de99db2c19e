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
their names.  The products stay ``torch.matmul``/``einsum`` and the
softmaxes ``torch.softmax``: the JAX package computes this outside any
Pallas kernel.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

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

    sim = torch.einsum("hid,hjd->hij", qk, cqk) * scale   # (h,N,M)
    neg = torch.finfo(sim.dtype).min
    if context_mask is not None:
        sim = torch.where(context_mask[None, None, :], sim, neg)
    sim_i = sim
    if mask is not None:
        sim_i = torch.where(mask[None, :, None], sim, neg)

    attn = torch.softmax(sim, dim=-1)                     # x attends context
    ctx_attn = torch.softmax(sim_i, dim=-2)               # context attends x

    out = torch.einsum("hij,hjd->hid", attn, cv)          # (h,N,d)
    ctx_out = torch.einsum("hij,hid->hjd", ctx_attn, v)   # (h,M,d)

    out = out.transpose(0, 1).reshape(x.shape[0], -1)
    ctx_out = ctx_out.transpose(0, 1).reshape(context.shape[0], -1)
    return (out @ p["to_out_w"] + p["to_out_b"],
            ctx_out @ p["ctx_out_w"] + p["ctx_out_b"])
