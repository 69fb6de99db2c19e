"""The card's peaks and the work the mathematics asks of a step or a frame.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
float32 outside the tensor cores 66.9 TFLOP/s (132 SMs × 128 lanes × 2
per multiply-add × 1.98 GHz), HBM3 3.35 TB/s.  The training step runs in
float32 with TF32 off, so no tensor-core peak applies.

Per blended (instance, pixel) pair, in float32 operations (a multiply-add
counts 2): the forward blend (K1) 11 for the power polynomial, 4 for the
exponential at its least cost and α = min(0.99, o·e), 3 for 1 − α, T·(1 −
α) and the stop test, 11 for the weight and the five weighted channel
sums; the backward blend (K2) the same 29 and 42 more (the weight, the
five channel products, the prefix and suffix, ∂L/∂α, the moment products
and the additions that fold the pair into its instance's sums).  Bytes:
each input byte read once and each output byte written once — a 64-byte
record per blended instance, the tile ranges, K1's six output rows per
pixel, K2's seven pixel rows read and a 64-byte row written per blended
instance.
"""
from __future__ import annotations

F32_PEAK = 66.9e12
HBM_PEAK = 3.35e12

K1_OPS_PER_PAIR = 11 + 4 + 3 + 11
K2_OPS_PER_PAIR = K1_OPS_PER_PAIR + 42
RECORD_BYTES = 64


def k1_work(w):
    """(operations, bytes) of the forward blend on a view's blended work
    ``w`` (``reference.blend.blended_work``)."""
    ops = K1_OPS_PER_PAIR * w["pairs"]
    moved = (RECORD_BYTES * w["instances"] + 8 * w["tiles"]
             + 6 * 4 * w["pixels"])
    return ops, moved


def k2_work(w):
    ops = K2_OPS_PER_PAIR * w["pairs"]
    moved = (2 * RECORD_BYTES * w["instances"] + 8 * w["tiles"]
             + 7 * 4 * w["pixels"])
    return ops, moved


def least_seconds(ops, moved):
    """The least time the card could take: the slower of its float32 pipe
    and its memory."""
    return max(ops / F32_PEAK, moved / HBM_PEAK)


def mlp_ops(feat_dim, n_offsets, anchors, backward=True):
    """The four decoders (in F + 4, hidden F; out k, k, 7k, 3k) over
    ``anchors`` anchors: forward, and twice that for the backward."""
    d_in, hid = feat_dim + 4, feat_dim
    fwd = sum(2 * (d_in * hid + hid * out)
              for out in (n_offsets, n_offsets, 7 * n_offsets,
                          3 * n_offsets))
    return anchors * fwd * (3 if backward else 1)


def attention_ops(tokens, dim, heads, dim_head):
    """The bidirectional cross-attention at ``tokens`` foreground and as
    many background tokens, forward and backward (3× the forward): the
    four input and two output projections, the similarity, the two
    weighted sums, and 5 operations per element of each softmax."""
    inner = heads * dim_head
    t = tokens
    fwd = (4 * 2 * t * dim * inner + 2 * 2 * t * inner * dim
           + 2 * heads * t * t * dim_head * 3 + 2 * 5 * heads * t * t)
    return 3 * fwd
