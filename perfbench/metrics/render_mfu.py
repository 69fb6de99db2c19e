"""render_mfu: the operations a frame needs (the four decoders' forward
over the visible anchors and the forward blend over the blended pairs;
the mean over the traced frames) over the untraced window's wall per
frame at the card's float32 peak, in %."""
from harness import work


def read(ctx):
    r = ctx.res
    if not r.work or r.capture is None or not r.capture.device:
        return None
    m = ctx.model
    ops = sum(work.mlp_ops(m["feat_dim"], m["n_offsets"], w["anchors"],
                           backward=False)
              + work.K1_OPS_PER_PAIR * w["pairs"]
              for w in r.work) / len(r.work)
    return 100.0 * ops / ((r.window_s / r.units) * work.F32_PEAK)
