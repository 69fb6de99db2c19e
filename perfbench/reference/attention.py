"""GScream's feature-consistency step: bidirectional cross-attention
between foreground and background anchors (``BidirectionalCrossAttention
(dim=32, heads=8, dim_head=64)`` driven by ``run_crossattn`` of GScream's
``gaussian_model.py``; token sampling in ``train.py``).

Anchors that project inside a sampled 256-pixel patch around the object
are split by the mask into foreground and background candidates; the
``min(n_fg, n_bg, 2000)`` of each with the highest uniform priorities are
the tokens.  Foreground tokens attend to background ones and back through
one shared similarity matrix; the outputs are mixed into the features
with the EMA weight 0.03, the foreground side only on the reference view.

Departures: the priorities are drawn as two uniform vectors over every
anchor slot from the run's device generator (the published code shuffles
with ``torch.randperm``); a masked position's similarity is the float32
minimum, not −inf.
"""
from __future__ import annotations

import torch


def tokens(pri_fg, pri_bg, pos, visible, alive, mask, box, width, height,
           max_tokens):
    """(fg_idx, bg_idx, fg_valid, bg_valid, ok) of one step."""
    px, py = pos[:, 0], pos[:, 1]
    xi = torch.clamp(px.to(torch.int32), 0, width - 1)
    yi = torch.clamp(py.to(torch.int32), 0, height - 1)
    inside = ((px > 0) & (px < width) & (py > 0) & (py < height) & visible
              & alive)
    in_box = ((yi >= box[0]) & (yi < box[1]) & (xi >= box[2])
              & (xi < box[3]) & inside)
    fg = mask[yi.long(), xi.long()] > 0.5
    fg_c, bg_c = in_box & fg, in_box & ~fg
    n_fg, n_bg = int(fg_c.sum()), int(bg_c.sum())
    n = min(n_fg, n_bg, max_tokens)
    rank = torch.arange(max_tokens, device=px.device)

    def draw(u, cand):
        idx = torch.topk(torch.where(cand, u, -torch.inf), max_tokens).indices
        return idx, rank < n
    fi, fv = draw(pri_fg, fg_c)
    bi, bv = draw(pri_bg, bg_c)
    return fi, bi, fv, bv, (n_fg > 11 and n_bg > 11)


def _heads(x, h):
    n, inner = x.shape
    return x.reshape(n, h, inner // h).transpose(0, 1)


def bidirectional(p, x, c, heads, dim_head, xmask, cmask):
    pre = "mlps/crossattn/"
    qk = _heads(x @ p[pre + "to_qk"], heads)
    cqk = _heads(c @ p[pre + "ctx_to_qk"], heads)
    v = _heads(x @ p[pre + "to_v"], heads)
    cv = _heads(c @ p[pre + "ctx_to_v"], heads)
    sim = torch.einsum("hid,hjd->hij", qk, cqk) * dim_head ** -0.5
    neg = torch.finfo(sim.dtype).min
    sim = torch.where(cmask[None, None, :], sim, neg)
    sim_i = torch.where(xmask[None, :, None], sim, neg)
    out = torch.einsum("hij,hjd->hid", torch.softmax(sim, -1), cv)
    cout = torch.einsum("hij,hid->hjd", torch.softmax(sim_i, -2), v)
    out = out.transpose(0, 1).reshape(x.shape[0], -1)
    cout = cout.transpose(0, 1).reshape(c.shape[0], -1)
    return (out @ p[pre + "to_out_w"] + p[pre + "to_out_b"],
            cout @ p[pre + "ctx_out_w"] + p[pre + "ctx_out_b"])


def mixed_features(p, feat, tok, ema, is_ref, heads, dim_head):
    """The features after the attention's EMA write, differentiable in the
    cross-attention arrays of ``p`` only."""
    fi, bi, fv, bv, ok = tok
    base = feat.detach()
    if not ok:
        return base
    ftok, btok = base[fi], base[bi]
    fout, bout = bidirectional(p, ftok, btok, heads, dim_head, fv, bv)
    out = base.clone()
    if is_ref:
        out = out.index_put((fi[fv],), (ema * fout + (1 - ema) * ftok)[fv])
    return out.index_put((bi[bv],), (ema * bout + (1 - ema) * btok)[bv])
