"""The training loop's host draws (GScream's ``train.py``): the camera
order, reshuffled each epoch, and per iteration, from a numpy generator
seeded with ``(seed, iteration)``, the reference view's random sub-box of
the enlarged mask box (its foreground depth term) and, in phase 2, the
256-pixel patch around the mask that the token draw samples from.

Departure: the streams are numpy ``SeedSequence`` generators keyed by
(seed, 77, epoch) and (seed, iteration), so that a run's draws are a
function of the seed and the iteration alone.
"""
from __future__ import annotations

import numpy as np


def view_of(seed: int, it: int, n_views: int) -> int:
    epoch, pos = divmod(it - 1, n_views)
    r = np.random.default_rng(np.random.SeedSequence([seed, 77, epoch]))
    return int(r.permutation(n_views)[pos])


def mask_bbox(mask: np.ndarray):
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return 0, 0, mask.shape[0], mask.shape[1]
    return ys.min(), xs.min(), ys.max() + 1, xs.max() + 1


def fg_box(rng, mask, h, w, enlarge=1.5, small=0.8):
    y0, x0, y1, x1 = mask_bbox(mask)
    bh, bw = y1 - y0, x1 - x0
    cy, cx = (y0 + y1) / 2, (x0 + x1) / 2
    nh, nw = enlarge * bh, enlarge * bw
    ny0, nx0 = max(0, cy - nh / 2), max(0, cx - nw / 2)
    sh, sw = small * bh, small * bw
    oy = rng.uniform(0, max(nh - sh, 0))
    ox = rng.uniform(0, max(nw - sw, 0))
    my0, mx0 = max(0, int(ny0 + oy)), max(0, int(nx0 + ox))
    my1, mx1 = min(int(my0 + sh), h - 1), min(int(mx0 + sw), w - 1)
    out = np.zeros((h, w), np.float32)
    out[my0:my1, mx0:mx1] = 1.0
    return out


def patch(rng, mask, size, small, h, w):
    y0, x0, y1, x1 = mask_bbox(mask)
    cy, cx = (y0 + y1) / 2, (x0 + x1) / 2
    ny0, nx0 = max(0, cy - size / 2), max(0, cx - size / 2)
    sw, sh = small * (x1 - x0), small * (y1 - y0)
    oy = rng.uniform(0, max(size - sh, 0))
    ox = rng.uniform(0, max(size - sw, 0))
    my0, mx0 = max(0, int(ny0 + oy)), max(0, int(nx0 + ox))
    return (my0, min(int(my0 + size), h - 1), mx0,
            min(int(mx0 + size), w - 1))


def iteration_draws(seed, it, mask, is_ref, cross, h, w, patch_size=256,
                    small=0.6):
    """(fg box (H,W) or None, patch (4,) or None) of iteration ``it``."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, it]))
    box = fg_box(rng, mask, h, w) if is_ref else None
    pt = patch(rng, mask, patch_size, small, h, w) if cross else None
    return box, pt
