"""train_mfu: the operations an iteration needs over the untraced
window's wall per iteration at the card's float32 peak, in %.  An
iteration needs the four decoders' forward and backward over the visible
anchors, the cross-attention at the drawn token count (phase 2), and the
forward and backward blend over the blended pairs; the mean over the
traced iterations (``harness.work``)."""
from harness import work


def read(ctx):
    r = ctx.res
    if not r.work or r.capture is None or not r.capture.device:
        return None
    m, o = ctx.model, ctx.optim
    ops = sum(work.mlp_ops(m["feat_dim"], m["n_offsets"], w["anchors"])
              + (work.K1_OPS_PER_PAIR + work.K2_OPS_PER_PAIR) * w["pairs"]
              + (work.attention_ops(w["tokens"], m["feat_dim"],
                                    o["attn_head_num"], o["attn_head_dim"])
                 if w["tokens"] else 0)
              for w in r.work) / len(r.work)
    return 100.0 * ops / ((r.window_s / r.units) * work.F32_PEAK)
