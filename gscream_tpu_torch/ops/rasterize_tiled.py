"""Tiled rasterizer, forward and analytic backward: K1, K2 and K3
(counterpart of ``gscream_tpu/ops/rasterize_tiled.py``).

Each instance becomes one 16-float record in the JAX package's legacy
layout ``[op, r, g, b, depth, unc, k0..k5, sx, sy, 0, 0]``
(``pack_instance_data``, :190-214): ``k0..k5`` are the coefficients of
the gaussian's exponent as a quadratic in tile-local pixel coordinates,
``power = k0 + (k1 + k3·x + k4·y)·x + (k2 + k5·y)·y``, so the blend costs a
handful of flops per (instance, pixel) pair.  K1 (:func:`run_forward`,
``csrc/rasterize_fwd.cu``) blends each 32×32 tile front to back; the image
crop and the background composite stay in torch.

The backward (:class:`_RasterizeTiled`, the ``_raster_fwd``/``_raster_bwd``
pair of the JAX package, :1180-1250) runs

1. K2 (:func:`run_backward`, ``csrc/rasterize_bwd.cu``): per instance, the
   channel sums Σw·g and the moments of X = ∂L/∂α·G in the gaussian's
   rounded-centre frame, in sorted (tile, depth) order;
2. K4 (:func:`~.shuffle.unpack_columns`): those rows → (16, capacity)
   columns, scattered to emission order by ``emit_slot`` (a permutation,
   so the scatter equals the JAX package's stable sort, :1079-1083);
3. K3 (:func:`segment_reduce_cm`, ``csrc/segreduce.cu``): the sums over
   each gaussian's contiguous emission run;
4. :func:`pergauss_chain`: moments → d_mean2d, d_conic, d_opacity, once
   per gaussian.

Steps 2-3 are the default ``GSCREAM_REORDER=cm``.  The row modes
(``gather``, ``scatter``, ``sort``; :func:`segment_reduce_grads`) scatter
K2's rows to emission order as rows and sum them with K7
(:func:`segment_reduce_rows`).  :func:`build_binning` is the JAX
package's emission selector: ``GSCREAM_EMIT=pallas`` builds the binning
with :func:`~.binning.bin_instances_pallas`, whose dense sorted records
:func:`pack_instance_data` transposes with K8
(:func:`~.shuffle.pack_columns`).  Both variables are read at call time.

K3 and K7 and their plain versions share one summation order, which
depends on the offsets alone.  Let ``n_live = min(offsets[N], cap)``
and cut the instances ``[0, n_live)``, in emission order, into chunks of
:data:`SEG_CHUNK` = 32 (one warp): chunk ``c = [32c, 32c + 32)``.
Inside a chunk, the instances of one gaussian form a segment.

1. Inside a chunk: a segmented Hillis–Steele inclusive scan over the 32
   slots for ``d = 1, 2, 4, 8, 16``.  Slot ``i``, whose segment starts at
   slot ``s`` (the slot of ``max(offsets[g], 32c)``), takes
   ``v[i] + v_prev[i − d]`` if ``i − d ≥ s`` and keeps ``v[i]``
   otherwise.  A segment's chunk partial is ``v`` at its last slot in the
   chunk.
2. Across chunks: a gaussian whose run lies in one chunk takes that
   partial; one whose run spans chunks ``c0 … c1`` adds its partials left
   to right, ``((p[c0] + p[c0+1]) + …) + p[c1]``, starting from
   ``p[c0]``.
3. An empty run, or one the capacity clamps away, gives a row of zeros.
4. Masking is a select (``torch.where``), never a multiply: a NaN or inf
   in one gaussian's instance cannot reach a neighbour in the same
   chunk, and stays in that gaussian's own sum.

So kernel and plain version are bit-equal, and so are K3 and K7 on the
same values; against the JAX package, which sums by indicator matmuls,
they agree to rtol 1e-5.  The binning gets no gradient.  No step uses
atomics, so the gradient of a rerun is bit-equal.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
from torch.profiler import record_function

from . import cuda_build as cb
from .binning import Binning, bin_instances, bin_instances_pallas
from .projection import ALPHA_MAX, ALPHA_MIN, T_STOP, Splats
from .shuffle import pack_columns, unpack_columns

TILE_W = 32           # pixels per tile, x
TILE_H = 32           # pixels per tile, y
PIX = TILE_W * TILE_H
ILANES = 16           # floats per instance record
SEG_CHUNK = 32        # instances per chunk of K3/K7's order: one warp


class TiledOut(NamedTuple):
    color: torch.Tensor        # (H,W,3) with background composited
    depth: torch.Tensor        # (H,W)
    uncertainty: torch.Tensor  # (H,W)
    final_t: torch.Tensor      # (H,W)


def gauss_attrs(mean2d, conic, opacity, colors, depth, unc):
    """(N, 11) attribute table [op, r, g, b, depth, unc, mx, my, ca, cb,
    cc]."""
    return torch.cat([opacity[:, None], colors, depth[:, None],
                      unc[:, None], mean2d, conic], dim=1)


def pack_instance_data(mean2d, conic, opacity, colors, depth, unc,
                       binning: Binning, grid_x: int) -> torch.Tensor:
    """Per-gaussian attributes → (capacity, 16) float32 instance records
    in sorted order, with the tile-local power coefficients and the
    centering shifts precomputed (legacy mode).  Slots past the live
    instances gather gaussian 0 at tile ``num_tiles``: finite, and outside
    every tile's range, so never read.  A binning that carries its sorted
    records as dense columns (``cols16``, the Pallas-emission build) is
    transposed by K8 instead (rasterize_tiled.py:164-174); its slots past
    the live instances are zero."""
    if binning.cols16 is not None:
        return pack_columns(binning.cols16)
    a = gauss_attrs(mean2d, conic, opacity, colors, depth, unc)[
        binning.gauss_id.long()]
    tile = binning.tile_id
    ox = ((tile % grid_x) * TILE_W).to(torch.float32)
    oy = ((tile // grid_x) * TILE_H).to(torch.float32)
    mxl = a[:, 6] - ox
    myl = a[:, 7] - oy
    ca, cb_, cc = a[:, 8], a[:, 9], a[:, 10]
    k0 = -0.5 * (ca * mxl * mxl + cc * myl * myl) - cb_ * mxl * myl
    k1 = ca * mxl + cb_ * myl
    k2 = cc * myl + cb_ * mxl
    # sx/sy: the backward's shift into the gaussian's rounded-center frame
    sx = ox - torch.round(a[:, 6])
    sy = oy - torch.round(a[:, 7])
    zero = torch.zeros_like(k0)
    return torch.stack([
        a[:, 0], a[:, 1], a[:, 2], a[:, 3], a[:, 4], a[:, 5],
        k0, k1, k2, -0.5 * ca, -cb_, -0.5 * cc, sx, sy, zero, zero,
    ], dim=1)


def _pixel_coords(device):
    p = torch.arange(PIX, device=device)
    return ((p % TILE_W).to(torch.float32)[None, :],
            (p // TILE_W).to(torch.float32)[None, :])


def run_forward_plain(inst, tile_start, tile_count,
                      n_tiles: int) -> torch.Tensor:
    """Plain version of K1; see :func:`run_forward`.  Per tile, vectorized
    over pixels: α of shape (count, 1024), then an inclusive ``cumprod``
    of 1−α gives T after each instance; an instance is blended only while
    that stays ≥ 1e-4, and the final T is the last such value."""
    dev = inst.device
    out = torch.zeros((n_tiles, 8, PIX), dtype=torch.float32, device=dev)
    out[:, 6] = 1.0
    x, y = _pixel_coords(dev)
    starts = tile_start.tolist()
    counts = tile_count.tolist()
    for t in range(n_tiles):
        c = counts[t]
        if c == 0:
            continue
        d = inst[starts[t]:starts[t] + c]
        k0, k1, k2 = d[:, 6:7], d[:, 7:8], d[:, 8:9]
        k3, k4, k5 = d[:, 9:10], d[:, 10:11], d[:, 11:12]
        power = k0 + (k1 + k3 * x + k4 * y) * x + (k2 + k5 * y) * y
        alpha = torch.clamp_max(d[:, 0:1] * torch.exp(power), ALPHA_MAX)
        alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha,
                            torch.zeros_like(alpha))
        t_after = torch.cumprod(1.0 - alpha, dim=0)
        t_before = torch.cat([torch.ones_like(t_after[:1]), t_after[:-1]])
        blend = t_after >= T_STOP
        w = torch.where(blend, alpha * t_before, torch.zeros_like(alpha))
        out[t, 1:6] = d[:, 1:6].T @ w
        out[t, 6] = torch.where(blend, t_after,
                                torch.ones_like(t_after)).amin(0)
    return out


def _tile_schedule(n_tiles: int, device) -> torch.Tensor:
    """K1's and K2's scratch: (1 + n_tiles,) int32, the work counter of
    their persistent grids and the tiles by descending count
    (``csrc/blend.cuh``); the kernels fill it."""
    return torch.empty(1 + n_tiles, dtype=torch.int32, device=device)


def run_forward(inst, tile_start, tile_count, n_tiles: int) -> torch.Tensor:
    """K1: (capacity, 16) float32 instance records in tile-sorted order
    and the (n_tiles,) int32 tile ranges → (n_tiles, 8, 1024) float32
    per-tile rows [0, Σw·r, Σw·g, Σw·b, Σw·depth, Σw·unc, final T, 0].
    The kernel shares power, α and both tests with K2 (``csrc/blend.cuh``)
    and takes e^power as one ``ex2.approx`` of power·log2(e)."""
    if inst.device.type == "cpu":
        return run_forward_plain(inst, tile_start, tile_count, n_tiles)
    cb.check(inst, "inst", torch.float32, (None, ILANES))
    cb.check(tile_start, "tile_start", torch.int32, (n_tiles,))
    cb.check(tile_count, "tile_count", torch.int32, (n_tiles,))
    out = torch.empty((n_tiles, 8, PIX), dtype=torch.float32,
                      device=inst.device)
    work = _tile_schedule(n_tiles, inst.device)
    fn = cb.function("rasterize_fwd", "gs_tile_forward", "pppippp")
    rc = fn(cb.ptr(inst), cb.ptr(tile_start), cb.ptr(tile_count), n_tiles,
            cb.ptr(work), cb.ptr(out), cb.stream_of(inst))
    cb.raise_on_error(rc, "tile_forward")
    run_forward.launches += 1
    return out


run_forward.launches = 0


def tiles_to_image(tiles: torch.Tensor, width: int, height: int):
    """(n_tiles, C, PIX) → (C, H, W) crop."""
    gx = -(-width // TILE_W)
    gy = -(-height // TILE_H)
    c = tiles.shape[1]
    img = tiles.reshape(gy, gx, c, TILE_H, TILE_W)
    img = img.permute(2, 0, 3, 1, 4).reshape(c, gy * TILE_H, gx * TILE_W)
    return img[:, :height, :width]


def image_to_tiles(img: torch.Tensor, width: int, height: int):
    """(C, H, W) → (n_tiles, C, PIX), zero-padded to whole tiles."""
    gx = -(-width // TILE_W)
    gy = -(-height // TILE_H)
    c = img.shape[0]
    pad = img.new_zeros((c, gy * TILE_H, gx * TILE_W))
    pad[:, :height, :width] = img
    t = pad.reshape(c, gy, TILE_H, gx, TILE_W)
    return t.permute(1, 3, 0, 2, 4).reshape(gy * gx, c, PIX)


def run_backward_plain(inst, pix_tiles, tile_start, tile_count,
                       n_tiles: int) -> torch.Tensor:
    """Plain version of K2; see :func:`run_backward`.  Per tile, vectorized
    over pixels like :func:`run_forward_plain`: the inclusive ``cumprod``
    gives T, an inclusive ``cumsum`` of γ·w the prefix, and the moments are
    sums over the tile's pixels in the rounded-centre frame."""
    dev = inst.device
    out = torch.zeros((inst.shape[0], ILANES), dtype=torch.float32,
                      device=dev)
    x, y = _pixel_coords(dev)
    starts = tile_start.tolist()
    counts = tile_count.tolist()
    for t in range(n_tiles):
        c = counts[t]
        if c == 0:
            continue
        s = starts[t]
        d = inst[s:s + c]
        g = pix_tiles[t]                          # (8, PIX)
        k0, k1, k2 = d[:, 6:7], d[:, 7:8], d[:, 8:9]
        k3, k4, k5 = d[:, 9:10], d[:, 10:11], d[:, 11:12]
        power = k0 + (k1 + k3 * x + k4 * y) * x + (k2 + k5 * y) * y
        g_exp = torch.exp(power)
        alpha = torch.clamp_max(d[:, 0:1] * g_exp, ALPHA_MAX)
        zero = torch.zeros_like(alpha)
        alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha,
                            zero)
        t_after = torch.cumprod(1.0 - alpha, dim=0)
        t_before = torch.cat([torch.ones_like(t_after[:1]), t_after[:-1]])
        applied = (alpha > 0.0) & (t_after >= T_STOP)
        w = torch.where(applied, alpha * t_before, zero)
        gamma = (d[:, 1:2] * g[0:1] + d[:, 2:3] * g[1:2] + d[:, 3:4] * g[2:3]
                 + d[:, 4:5] * g[3:4] + d[:, 5:6] * g[4:5])
        suffix = g[5:6] - torch.cumsum(gamma * w, dim=0) + g[6:7]
        # where, not a product with 0: exp(power) of a pair the kernel
        # skips (power > 0) may be inf
        X = torch.where(applied, (gamma * t_before - suffix / (1.0 - alpha))
                        * g_exp, zero)
        xs = x + d[:, 12:13]
        ys = y + d[:, 13:14]
        out[s:s + c, 1:6] = w @ g[0:5].T
        for lane, m in enumerate((X, X * xs, X * ys, X * xs * xs,
                                  X * xs * ys, X * ys * ys), start=6):
            out[s:s + c, lane] = m.sum(1)
    return out


def run_backward(inst, pix_tiles, tile_start, tile_count,
                 n_tiles: int) -> torch.Tensor:
    """K2: the K1 records and the (n_tiles, 8, 1024) per-pixel rows
    ``[g_r, g_g, g_b, g_depth, g_unc, Total, gTT, 0]`` → (capacity, 16)
    gradient rows in sorted order: lanes 1-5 Σ_p w·g, lanes 6-11 the
    moments of X = ∂L/∂α·G against ``[1, x, y, x², xy, y²]`` in the
    gaussian's rounded-centre frame, lanes 0 and 12-15 zero.  Slots no
    tile blends (past a tile's early stop, before the first tile's range,
    past the last tile's) are zero.  The tile ranges must be ascending
    and contiguous, as :func:`~.binning.bin_instances` lays them out; a
    band of a sharded grid (``parallel/shard.py``) passes the ranges of
    its own tiles, which start past slot 0."""
    if inst.device.type == "cpu":
        return run_backward_plain(inst, pix_tiles, tile_start, tile_count,
                                  n_tiles)
    cb.check(inst, "inst", torch.float32, (None, ILANES))
    cb.check(pix_tiles, "pix_tiles", torch.float32, (n_tiles, 8, PIX))
    cb.check(tile_start, "tile_start", torch.int32, (n_tiles,))
    cb.check(tile_count, "tile_count", torch.int32, (n_tiles,))
    out = torch.empty_like(inst)
    work = _tile_schedule(n_tiles, inst.device)
    fn = cb.function("rasterize_bwd", "gs_tile_backward", "ppppiippp")
    rc = fn(cb.ptr(inst), cb.ptr(pix_tiles), cb.ptr(tile_start),
            cb.ptr(tile_count), n_tiles, inst.shape[0], cb.ptr(work),
            cb.ptr(out), cb.stream_of(inst))
    cb.raise_on_error(rc, "tile_backward")
    run_backward.launches += 1
    return out


run_backward.launches = 0


def pergauss_chain(pg, mean2d, conic, opacity):
    """Per-gaussian moment sums → (d_mean2d, d_conic, d_op, d_col,
    d_depth, d_unc) (rasterize_tiled.py:848-879): the moment form of
    ∂power/∂(mean, conic) is translation-covariant, so the chain runs once
    per gaussian on the centred moments."""
    d_col = pg[:, 1:4]
    d_depth = pg[:, 4]
    d_unc = pg[:, 5]
    m0, mxs, mys = pg[:, 6], pg[:, 7], pg[:, 8]
    mxxs, mxys, myys = pg[:, 9], pg[:, 10], pg[:, 11]
    mxc = mean2d[:, 0] - torch.round(mean2d[:, 0])
    myc = mean2d[:, 1] - torch.round(mean2d[:, 1])
    ca, cb_, cc = conic[:, 0], conic[:, 1], conic[:, 2]
    op = opacity
    d_op = m0
    dmx = op * (-(ca * mxc + cb_ * myc) * m0 + ca * mxs + cb_ * mys)
    dmy = op * (-(cc * myc + cb_ * mxc) * m0 + cc * mys + cb_ * mxs)
    dca = op * (-0.5) * (mxc * mxc * m0 - 2.0 * mxc * mxs + mxxs)
    dcc = op * (-0.5) * (myc * myc * m0 - 2.0 * myc * mys + myys)
    dcb = op * (-(mxc * myc * m0 - mxc * mys - myc * mxs + mxys))
    d_mean2d = torch.stack([dmx, dmy], dim=1)
    d_conic = torch.stack([dca, dcb, dcc], dim=1)
    return d_mean2d, d_conic, d_op, d_col, d_depth, d_unc


def _chunk_sums(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """(N, 16) sums of the (cap, 16) ``values`` over each gaussian's run in
    the order of the module docstring, vectorized: the live slots as
    (chunks, 32, 16), five ``torch.where`` scan steps, each segment's
    partial at its last slot, then a loop over the chunk index that adds a
    spanning run's partials left to right."""
    cap = values.shape[0]
    offs = offsets.long()
    lo = torch.clamp_max(offs[:-1], cap)
    hi = torch.clamp_max(offs[1:], cap)
    out = torch.zeros((lo.shape[0], ILANES), dtype=torch.float32,
                      device=values.device)
    n_live = min(int(offs[-1]), cap)
    chunks = -(-n_live // SEG_CHUNK)
    if chunks == 0 or lo.numel() == 0:
        return out
    slots = chunks * SEG_CHUNK
    e = torch.arange(slots, device=values.device)
    g = torch.searchsorted(offs, e, right=True) - 1     # the slot's gaussian
    base = e - e % SEG_CHUNK
    start = torch.clamp_min(offs[torch.clamp_min(g, 0)], base) - base
    # a slot past the live instances or before offsets[0] has no segment
    start = torch.where((g >= 0) & (e < n_live), start, SEG_CHUNK)
    lane = (e % SEG_CHUNK).reshape(chunks, SEG_CHUNK, 1)
    start = start.reshape(chunks, SEG_CHUNK, 1)
    v = torch.zeros((slots, ILANES), dtype=torch.float32,
                    device=values.device)
    v[:n_live] = values[:n_live]
    v = v.reshape(chunks, SEG_CHUNK, ILANES)
    d = 1
    while d < SEG_CHUNK:
        up = torch.zeros_like(v)
        up[:, d:] = v[:, :-d]
        v = torch.where(lane - d >= start, v + up, v)
        d *= 2
    v = v.reshape(slots, ILANES)

    emit = hi > lo
    c0 = torch.div(lo, SEG_CHUNK, rounding_mode="floor")
    c1 = torch.div(hi - 1, SEG_CHUNK, rounding_mode="floor")

    def partial(c):     # each run's partial in chunk c: v at its last slot
        last = torch.minimum(hi - 1, c * SEG_CHUNK + SEG_CHUNK - 1)
        return v[torch.clamp(last, 0, slots - 1)]
    acc = partial(c0)
    span = int((c1 - c0)[emit].max()) if bool(emit.any()) else 0
    for j in range(1, span + 1):
        acc = torch.where((c0 + j <= c1)[:, None], acc + partial(c0 + j),
                          acc)
    return torch.where(emit[:, None], acc, out)


def _segment_reduce(src: torch.Tensor, offsets: torch.Tensor, cap: int,
                    symbol: str) -> torch.Tensor:
    """Launch K3 or K7 (``symbol``) on ``src``: both levels, with the
    (2, chunks, 16) scratch partials allocated here."""
    cb.check(offsets, "offsets", torch.int32, (None,))
    n = offsets.shape[0] - 1
    out = torch.empty((n, ILANES), dtype=torch.float32, device=src.device)
    scratch = torch.empty((2, -(-cap // SEG_CHUNK), ILANES),
                          dtype=torch.float32, device=src.device)
    fn = cb.function("segreduce", symbol, "ppiippp")
    rc = fn(cb.ptr(src), cb.ptr(offsets), n, cap, cb.ptr(scratch),
            cb.ptr(out), cb.stream_of(src))
    cb.raise_on_error(rc, symbol)
    return out


def segment_reduce_cm_plain(cols: torch.Tensor,
                            offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of K3; see :func:`segment_reduce_cm`."""
    return _chunk_sums(cols.T, offsets)


def segment_reduce_cm(cols: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    """K3: (16, capacity) float32 columns in emission order and the (N+1,)
    int32 emission offsets → (N, 16) sums of each gaussian's run
    ``[offsets[g], offsets[g+1])``, the offsets clamped to the capacity
    (rasterize_tiled.py:939-989), in the order of the module docstring."""
    if cols.device.type == "cpu":
        return segment_reduce_cm_plain(cols, offsets)
    cb.check(cols, "cols", torch.float32, (ILANES, None))
    out = _segment_reduce(cols, offsets, cols.shape[1], "gs_segment_reduce")
    segment_reduce_cm.launches += 1
    return out


segment_reduce_cm.launches = 0


def emission_columns(rows: torch.Tensor, binning: Binning) -> torch.Tensor:
    """K2's (capacity, 16) rows in sorted order → (16, capacity) columns in
    emission order (``reduce_grads_cm``, :1044-1083): K4, which zeroes the
    non-finite entries as it transposes (its sanitize, :1073), then the
    column scatter ``out[:, emit_slot] = cols``.  ``emit_slot`` is a
    permutation of the slots, so the scatter is bit-equal to the JAX
    package's stable sort on it (:1079-1083)."""
    cols = unpack_columns(rows)
    return torch.empty_like(cols).index_copy_(1, binning.emit_slot.long(),
                                              cols)


def segment_reduce_rows_plain(rows: torch.Tensor,
                              offsets: torch.Tensor) -> torch.Tensor:
    """Plain version of K7; see :func:`segment_reduce_rows`."""
    return _chunk_sums(rows, offsets)


def segment_reduce_rows(rows: torch.Tensor,
                        offsets: torch.Tensor) -> torch.Tensor:
    """K7: (capacity, 16) float32 rows in emission order and the (N+1,)
    int32 emission offsets → (N, 16) sums of each gaussian's run
    ``[offsets[g], offsets[g+1])``, the offsets clamped to the capacity
    (``segment_reduce_grads``' kernel, rasterize_tiled.py:992-1032), in
    the order of the module docstring: bit-equal to K3 on the transposed
    values."""
    if rows.device.type == "cpu":
        return segment_reduce_rows_plain(rows, offsets)
    cb.check(rows, "rows", torch.float32, (None, ILANES))
    out = _segment_reduce(rows, offsets, rows.shape[0],
                          "gs_segment_reduce_rows")
    segment_reduce_rows.launches += 1
    return out


segment_reduce_rows.launches = 0


def _reorder_mode() -> str:
    """``GSCREAM_REORDER`` (rasterize_tiled.py:1035-1041)."""
    mode = os.environ.get("GSCREAM_REORDER", "cm")
    if mode not in ("cm", "gather", "scatter", "sort"):
        raise ValueError(
            f"GSCREAM_REORDER={mode!r}: must be one of "
            "'cm', 'gather', 'scatter', 'sort'")
    return mode


def segment_reduce_grads(conv: torch.Tensor,
                         binning: Binning) -> torch.Tensor:
    """(capacity, 16) sorted-order K2 rows → (N, 16) per-gaussian sums in
    the row modes of ``GSCREAM_REORDER`` (rasterize_tiled.py:1087-1165):
    the row scatter ``out[emit_slot] = conv`` into emission order, then K7
    sums each gaussian's run.  The JAX package's three modes (``gather``,
    ``scatter``, ``sort``) differ only in how they lower on the TPU: each
    takes the rows to emission order by the permutation ``emit_slot``, and
    the one that carries lanes 1-11 alone (``sort``) drops lanes K2 writes
    as zeros.  So one reorder serves all three, bit-equal to each.  Unlike
    the cm flow, nothing is sanitized here, as in the JAX package."""
    if _reorder_mode() == "cm":
        raise ValueError("GSCREAM_REORDER=cm routes through "
                         "segment_reduce_cm, not segment_reduce_grads")
    ge = torch.empty_like(conv).index_copy_(0, binning.emit_slot.long(),
                                            conv)
    return segment_reduce_rows(ge, binning.offsets)


def per_gaussian_sums(rows: torch.Tensor, binning: Binning) -> torch.Tensor:
    """K2's (capacity, 16) rows in sorted order → (N, 16) sums over each
    gaussian's instances (rasterize_tiled.py:1224-1237): K4, the column
    scatter and K3 under ``GSCREAM_REORDER=cm``, the row scatter and K7
    otherwise."""
    if os.environ.get("GSCREAM_SCATTER_REDUCE"):
        raise NotImplementedError(
            "GSCREAM_SCATTER_REDUCE (an atomic segment_sum) is not "
            "ported; unset it")
    if _reorder_mode() == "cm":
        with record_function("raster_bwd/K4 unpack + reorder"):
            ge = emission_columns(rows, binning)
        with record_function("raster_bwd/K3 segment_reduce"):
            return segment_reduce_cm(ge, binning.offsets)
    with record_function("raster_bwd/reorder + K7 segment_reduce"):
        return segment_reduce_grads(rows, binning)


def pixel_rows(raw_c, d_img, u_img, t_img, bg, g_color, g_depth, g_unc,
               g_tfin, width: int, height: int) -> torch.Tensor:
    """K2's per-pixel input, (n_tiles, 8, 1024) rows ``[g_r, g_g, g_b,
    g_depth, g_unc, Total, gTT, 0]`` (``_raster_bwd``, :1209-1220), from
    the forward's un-composited colour ``raw_c`` (3,H,W), depth,
    uncertainty and final T (H,W), the background and the cotangents
    (``g_color`` as (3,H,W)).  ``Total = Σ_c raw_c·g_c + D·g_D + U·g_U``
    is Σ_i γ_i·w_i over the pixel's blended instances; ``gTT`` carries
    the final-T cotangent, direct and through the background."""
    gc = g_color
    gtt = (bg[0] * gc[0] + bg[1] * gc[1] + bg[2] * gc[2] + g_tfin) * t_img
    total = (raw_c[0] * gc[0] + raw_c[1] * gc[1] + raw_c[2] * gc[2]
             + d_img * g_depth + u_img * g_unc)
    pix = torch.stack([gc[0], gc[1], gc[2], g_depth, g_unc, total, gtt,
                       torch.zeros_like(g_depth)])
    return image_to_tiles(pix, width, height)


class _RasterizeTiled(torch.autograd.Function):
    """``_raster_fwd`` / ``_raster_bwd`` (rasterize_tiled.py:1180-1250)."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, colors, depth, unc, bg,
                binning: Binning, width: int, height: int):
        gx = -(-width // TILE_W)
        gy = -(-height // TILE_H)
        inst = pack_instance_data(mean2d, conic, opacity, colors, depth,
                                  unc, binning, gx)
        tiles = run_forward(inst, binning.tile_start, binning.tile_count,
                            gx * gy)
        img = tiles_to_image(tiles, width, height)     # (8,H,W)
        raw_c, d_img, u_img, t_img = img[1:4], img[4], img[5], img[6]
        color = raw_c + t_img[None] * bg[:, None, None]
        ctx.save_for_backward(inst, bg, raw_c, d_img, u_img, t_img, mean2d,
                              conic, opacity)
        ctx.binning = binning
        ctx.size = (width, height)
        return color.permute(1, 2, 0), d_img, u_img, t_img

    @staticmethod
    def backward(ctx, g_color, g_depth, g_unc, g_tfin):
        (inst, bg, raw_c, d_img, u_img, t_img, mean2d, conic,
         op) = ctx.saved_tensors
        binning = ctx.binning
        gc = g_color.permute(2, 0, 1)                  # (3,H,W)
        with record_function("raster_bwd/K2 tile_backward"):
            pix = pixel_rows(raw_c, d_img, u_img, t_img, bg, gc, g_depth,
                             g_unc, g_tfin, *ctx.size)
            rows = run_backward(inst, pix, binning.tile_start,
                                binning.tile_count,
                                binning.tile_start.shape[0])
        pg = per_gaussian_sums(rows, binning)
        with record_function("raster_bwd/chain"):
            grads = pergauss_chain(pg, mean2d, conic, op)
            # out_color = C + T·bg  ⇒  d bg = Σ_p T_p · g_color_p
            d_bg = (t_img[None] * gc).sum(dim=(1, 2))
        return grads + (d_bg, None, None, None)


def rasterize_tiled(mean2d, conic, opacity, colors, depth, unc,
                    binning: Binning, bg, width: int,
                    height: int) -> TiledOut:
    """Tile rasterization with the background composite, differentiable in
    ``mean2d, conic, opacity, colors, depth, unc`` and ``bg`` (the binning
    gets no gradient)."""
    return TiledOut(*_RasterizeTiled.apply(mean2d, conic, opacity, colors,
                                           depth, unc, bg, binning, width,
                                           height))


def build_binning(splats: Splats, opacity, colors, unc, capacity: int,
                  width: int, height: int) -> Binning:
    """The JAX package's emission selector (rasterize_tiled.py:1259-1292),
    with its conditions, read at call time: ``GSCREAM_EMIT=pallas`` takes
    :func:`~.binning.bin_instances_pallas` when the capacity is a
    multiple of 1024, else (as for ``GSCREAM_EMIT=xla``, the default)
    :func:`~.binning.bin_instances`.  Where the JAX package would take a
    mode the port does not have — raw-coefficient kernels
    (``GSCREAM_KERNEL_COEFF=1``), full-rect emission
    (``GSCREAM_ROW_TIGHT=0`` or no ``t_iso``) or the XLA build's fused
    sort key (``GSCREAM_SORT_FUSED``) — this raises
    ``NotImplementedError``.
    Call it under ``torch.no_grad()``: the binning carries no gradient."""
    env = os.environ.get
    if env("GSCREAM_KERNEL_COEFF", "0") == "1":
        raise NotImplementedError("GSCREAM_KERNEL_COEFF=1 (raw-coefficient "
                                  "kernels) is not ported")
    if env("GSCREAM_ROW_TIGHT") == "0":
        raise NotImplementedError("GSCREAM_ROW_TIGHT=0 (full-rect "
                                  "emission) is not ported")
    if (env("GSCREAM_EMIT", "xla") == "pallas" and splats.t_iso is not None
            and env("GSCREAM_SORT_FUSED") != "1" and capacity % 1024 == 0):
        return bin_instances_pallas(splats, opacity, colors, unc, capacity,
                                    width, height, TILE_W, TILE_H)
    if env("GSCREAM_SORT_FUSED"):
        raise NotImplementedError("GSCREAM_SORT_FUSED (the fused sort key "
                                  "of the XLA build) is not ported")
    # splats without t_iso (full-rect emission) raise in bin_instances
    return bin_instances(splats, capacity, width, height, TILE_W, TILE_H)
