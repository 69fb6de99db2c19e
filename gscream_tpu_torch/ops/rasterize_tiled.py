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

Under ``GSCREAM_KERNEL_COEFF=1`` (raw mode, rasterize_tiled.py:117) the
record is the gaussian's own ``[op, r, g, b, depth, unc, mx, my, ca, cb,
cc, 0×5]``, one gather, and the raw bodies of K1 and K2
(:func:`run_forward_raw`, :func:`run_backward_raw`) derive ``k0..k5`` and
``sx, sy`` per tile from the tile's origin, found from its global id
``tile_base + t`` (:378-383, :546-551, ``_raw_coeffs`` :285-300): one
rounding per operation, in the legacy pack's order, so raw and legacy
blend the same coefficients bit for bit.

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

Steps 2-3 are the default ``GSCREAM_REORDER=cm``.
``GSCREAM_SCATTER_REDUCE`` replaces them with one ``index_add_`` of the
rows over ``gauss_id`` (JAX's ``segment_sum``, :1227-1231).  The row modes
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
atomics, so the gradient of a rerun is bit-equal — except under
``GSCREAM_SCATTER_REDUCE``, whose ``index_add_`` adds with atomics on
the card in an order that changes from run to run (agreeing with K3 to
rtol 1e-5); the bit-exact resume holds for the other modes.

``GSCREAM_MXU_POWER=1`` moves the power polynomial of the TPU kernels
onto the TPU's matrix unit; the same power is computed either way, so the
port ignores it, except that, as in the JAX package (:276-280), it may
not be combined with ``GSCREAM_KERNEL_COEFF=1``.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
from torch.profiler import record_function

from . import cuda_build as cb
from .binning import (Binning, bin_instances, bin_instances_pallas,
                      full_rect, overflow_demand)
from .projection import ALPHA_MAX, ALPHA_MIN, T_STOP, Splats, preprocess
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


def kernel_coeff() -> bool:
    """``GSCREAM_KERNEL_COEFF=1`` (raw mode, module docstring), read per
    call; raises under ``GSCREAM_MXU_POWER=1`` as the JAX package does
    (rasterize_tiled.py:276-280)."""
    raw = os.environ.get("GSCREAM_KERNEL_COEFF", "0") == "1"
    if raw and os.environ.get("GSCREAM_MXU_POWER") == "1":
        raise RuntimeError(
            "GSCREAM_MXU_POWER=1 requires the legacy precomputed-coefficient "
            "packing (set GSCREAM_KERNEL_COEFF=0): the MXU power contraction "
            "reads k0..k5 from the instance lanes")
    return raw


def gauss_attrs(mean2d, conic, opacity, colors, depth, unc):
    """(N, 11) attribute table [op, r, g, b, depth, unc, mx, my, ca, cb,
    cc]."""
    return torch.cat([opacity[:, None], colors, depth[:, None],
                      unc[:, None], mean2d, conic], dim=1)


def legacy_records(a, ox, oy) -> torch.Tensor:
    """(R, 16) legacy records from (R, ≥11) raw rows and their tiles'
    origins ``ox, oy`` ((R,) float32): the tile-local power coefficients
    and the centering shifts, one rounding per operation
    (rasterize_tiled.py:204-214, ``_raw_coeffs`` :285-300)."""
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


def tile_origin(tile, grid_x: int):
    """Tile ids → the float32 pixel origins (ox, oy) of those tiles."""
    return (((tile % grid_x) * TILE_W).to(torch.float32),
            (torch.div(tile, grid_x, rounding_mode="floor")
             * TILE_H).to(torch.float32))


def pack_instance_data(mean2d, conic, opacity, colors, depth, unc,
                       binning: Binning, grid_x: int,
                       raw: bool = False) -> torch.Tensor:
    """Per-gaussian attributes → (capacity, 16) float32 instance records
    in sorted order: with the tile-local power coefficients and the
    centering shifts precomputed (legacy mode), or, with ``raw``, the
    attribute rows padded to 16 lanes (raw mode, :188-192).  Slots past
    the live instances gather a gaussian at tile ``num_tiles``: finite,
    and outside every tile's range, so never read.  A binning that carries
    its sorted records as dense columns (``cols16``, the Pallas-emission
    build, never taken in raw mode) is transposed by K8 instead
    (rasterize_tiled.py:164-174); its slots past the live instances are
    zero."""
    if binning.cols16 is not None:
        return pack_columns(binning.cols16)
    a = gauss_attrs(mean2d, conic, opacity, colors, depth, unc)[
        binning.gauss_id.long()]
    if raw:
        return torch.nn.functional.pad(a, (0, ILANES - a.shape[1]))
    return legacy_records(a, *tile_origin(binning.tile_id, grid_x))


def _pixel_coords(device):
    p = torch.arange(PIX, device=device)
    return ((p % TILE_W).to(torch.float32)[None, :],
            (p // TILE_W).to(torch.float32)[None, :])


def _tile_records(inst, start: int, count: int, t: int, raw):
    """Tile ``t``'s records ``inst[start:start+count]``, turned into legacy
    records in raw mode (``raw`` = (grid_x, tile_base), or None)."""
    d = inst[start:start + count]
    if raw is None:
        return d
    grid_x, tile_base = raw
    ox, oy = tile_origin(torch.full_like(d[:, 0], tile_base + t,
                                         dtype=torch.int64), grid_x)
    return legacy_records(d, ox, oy)


def run_forward_plain(inst, tile_start, tile_count, n_tiles: int,
                      raw=None) -> torch.Tensor:
    """Plain version of K1; see :func:`run_forward`.  Per tile, vectorized
    over pixels: α of shape (count, 1024), then an inclusive ``cumprod``
    of 1−α gives T after each instance; an instance is blended only while
    that stays ≥ 1e-4, and the final T is the last such value.  With
    ``raw`` = (grid_x, tile_base) the records are raw and each tile's are
    turned into legacy ones first (:func:`run_forward_raw_plain`)."""
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
        d = _tile_records(inst, starts[t], c, t, raw)
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


def run_forward_raw_plain(inst, tile_start, tile_count, n_tiles: int,
                          grid_x: int, tile_base: int = 0) -> torch.Tensor:
    """Plain version of raw K1; see :func:`run_forward_raw`."""
    return run_forward_plain(inst, tile_start, tile_count, n_tiles,
                             (grid_x, tile_base))


def run_forward_raw(inst, tile_start, tile_count, n_tiles: int, grid_x: int,
                    tile_base: int = 0) -> torch.Tensor:
    """Raw K1 (``_fwd_kernel`` under ``GSCREAM_KERNEL_COEFF=1``): as
    :func:`run_forward`, on raw records ``[op, r, g, b, depth, unc, mx,
    my, ca, cb, cc, 0×5]``; the kernel finds tile ``t``'s origin from its
    global id ``tile_base + t`` on a grid ``grid_x`` tiles wide (a band of
    a sharded grid passes its first global tile) and derives the legacy
    coefficients as it stages each record (``csrc/rasterize_fwd.cu``)."""
    if inst.device.type == "cpu":
        return run_forward_raw_plain(inst, tile_start, tile_count, n_tiles,
                                     grid_x, tile_base)
    cb.check(inst, "inst", torch.float32, (None, ILANES))
    cb.check(tile_start, "tile_start", torch.int32, (n_tiles,))
    cb.check(tile_count, "tile_count", torch.int32, (n_tiles,))
    out = torch.empty((n_tiles, 8, PIX), dtype=torch.float32,
                      device=inst.device)
    work = _tile_schedule(n_tiles, inst.device)
    fn = cb.function("rasterize_fwd", "gs_tile_forward_raw", "pppiiippp")
    rc = fn(cb.ptr(inst), cb.ptr(tile_start), cb.ptr(tile_count), n_tiles,
            grid_x, tile_base, cb.ptr(work), cb.ptr(out), cb.stream_of(inst))
    cb.raise_on_error(rc, "tile_forward_raw")
    run_forward_raw.launches += 1
    return out


run_forward_raw.launches = 0


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
                       n_tiles: int, raw=None) -> torch.Tensor:
    """Plain version of K2; see :func:`run_backward`.  Per tile, vectorized
    over pixels like :func:`run_forward_plain`: the inclusive ``cumprod``
    gives T, an inclusive ``cumsum`` of γ·w the prefix, and the moments are
    sums over the tile's pixels in the rounded-centre frame.  ``raw`` as
    in :func:`run_forward_plain`."""
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
        d = _tile_records(inst, s, c, t, raw)
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


def run_backward_raw_plain(inst, pix_tiles, tile_start, tile_count,
                           n_tiles: int, grid_x: int,
                           tile_base: int = 0) -> torch.Tensor:
    """Plain version of raw K2; see :func:`run_backward_raw`."""
    return run_backward_plain(inst, pix_tiles, tile_start, tile_count,
                              n_tiles, (grid_x, tile_base))


def run_backward_raw(inst, pix_tiles, tile_start, tile_count, n_tiles: int,
                     grid_x: int, tile_base: int = 0) -> torch.Tensor:
    """Raw K2 (``_bwd_kernel`` under ``GSCREAM_KERNEL_COEFF=1``): as
    :func:`run_backward`, on raw records, with each tile's origin and the
    shifts ``sx = ox − rint(mx)``, ``sy = oy − rint(my)`` derived in the
    kernel as in :func:`run_forward_raw` (``csrc/rasterize_bwd.cu``)."""
    if inst.device.type == "cpu":
        return run_backward_raw_plain(inst, pix_tiles, tile_start,
                                      tile_count, n_tiles, grid_x, tile_base)
    cb.check(inst, "inst", torch.float32, (None, ILANES))
    cb.check(pix_tiles, "pix_tiles", torch.float32, (n_tiles, 8, PIX))
    cb.check(tile_start, "tile_start", torch.int32, (n_tiles,))
    cb.check(tile_count, "tile_count", torch.int32, (n_tiles,))
    out = torch.empty_like(inst)
    work = _tile_schedule(n_tiles, inst.device)
    fn = cb.function("rasterize_bwd", "gs_tile_backward_raw", "ppppiiiippp")
    rc = fn(cb.ptr(inst), cb.ptr(pix_tiles), cb.ptr(tile_start),
            cb.ptr(tile_count), n_tiles, inst.shape[0], grid_x, tile_base,
            cb.ptr(work), cb.ptr(out), cb.stream_of(inst))
    cb.raise_on_error(rc, "tile_backward_raw")
    run_backward_raw.launches += 1
    return out


run_backward_raw.launches = 0


def tile_forward(inst, tile_start, tile_count, n_tiles: int, raw: bool,
                 grid_x: int, tile_base: int = 0) -> torch.Tensor:
    """K1 in the records' mode: :func:`run_forward_raw` or
    :func:`run_forward` (looked up per call)."""
    if raw:
        return run_forward_raw(inst, tile_start, tile_count, n_tiles,
                               grid_x, tile_base)
    return run_forward(inst, tile_start, tile_count, n_tiles)


def tile_backward(inst, pix_tiles, tile_start, tile_count, n_tiles: int,
                  raw: bool, grid_x: int, tile_base: int = 0) -> torch.Tensor:
    """K2 in the records' mode: :func:`run_backward_raw` or
    :func:`run_backward`."""
    if raw:
        return run_backward_raw(inst, pix_tiles, tile_start, tile_count,
                                n_tiles, grid_x, tile_base)
    return run_backward(inst, pix_tiles, tile_start, tile_count, n_tiles)


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


def scatter_reduce_sums(rows: torch.Tensor,
                        binning: Binning) -> torch.Tensor:
    """``GSCREAM_SCATTER_REDUCE`` (rasterize_tiled.py:1227-1231, an XLA
    ``segment_sum``): K2's rows added into their gaussians' rows by
    ``index_add_`` over ``gauss_id``.  On the card the adds are atomic,
    so their order, and a sum's last bits, change from run to run; the
    result agrees with K3's to rtol 1e-5.  Nothing is sanitized, as in the
    JAX package."""
    n = binning.offsets.shape[0] - 1
    cap = binning.gauss_id.shape[0]
    return torch.zeros((n, ILANES), dtype=torch.float32,
                       device=rows.device).index_add_(
        0, binning.gauss_id.long(), rows[:cap])


def per_gaussian_sums(rows: torch.Tensor, binning: Binning) -> torch.Tensor:
    """K2's (capacity, 16) rows in sorted order → (N, 16) sums over each
    gaussian's instances, the whole frame's reduction (rasterize_tiled.py:
    1224-1237): :func:`scatter_reduce_sums` under
    ``GSCREAM_SCATTER_REDUCE``, else :func:`segment_sums`."""
    if os.environ.get("GSCREAM_SCATTER_REDUCE"):
        with record_function("raster_bwd/scatter_reduce"):
            return scatter_reduce_sums(rows, binning)
    return segment_sums(rows, binning)


def segment_sums(rows: torch.Tensor, binning: Binning) -> torch.Tensor:
    """K2's rows → per-gaussian sums through the ``GSCREAM_REORDER``
    selector alone: K4, the column scatter and K3 under ``cm``, the row
    scatter and K7 otherwise.  The band backward reduces here whatever
    ``GSCREAM_SCATTER_REDUCE`` says, as JAX's ``_band_bwd_at`` does
    (parallel/shard.py:165-174)."""
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
        raw = kernel_coeff()
        inst = pack_instance_data(mean2d, conic, opacity, colors, depth,
                                  unc, binning, gx, raw)
        tiles = tile_forward(inst, binning.tile_start, binning.tile_count,
                             gx * gy, raw, gx)
        img = tiles_to_image(tiles, width, height)     # (8,H,W)
        raw_c, d_img, u_img, t_img = img[1:4], img[4], img[5], img[6]
        color = raw_c + t_img[None] * bg[:, None, None]
        ctx.save_for_backward(inst, bg, raw_c, d_img, u_img, t_img, mean2d,
                              conic, opacity)
        ctx.binning = binning
        ctx.size = (width, height)
        ctx.raw = raw
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
            n_tiles = binning.tile_start.shape[0]
            rows = tile_backward(inst, pix, binning.tile_start,
                                 binning.tile_count, n_tiles, ctx.raw,
                                 -(-ctx.size[0] // TILE_W))
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
                  width: int, height: int, precise: bool = True) -> Binning:
    """The JAX package's emission selector (rasterize_tiled.py:1259-1292),
    condition for condition, read at call time: the Pallas-emission build
    :func:`~.binning.bin_instances_pallas` only under
    ``GSCREAM_EMIT=pallas`` with ``precise``, not in raw mode, with
    ``t_iso``, ``GSCREAM_ROW_TIGHT`` not ``0``, ``GSCREAM_SORT_FUSED`` not
    ``1`` and a capacity that is a multiple of 1024; otherwise
    :func:`~.binning.bin_instances` (row-tight or full-rect emission, the
    precise or the quantized sort).  Call it under ``torch.no_grad()``:
    the binning carries no gradient."""
    env = os.environ.get
    if (env("GSCREAM_EMIT", "xla") == "pallas" and precise
            and not kernel_coeff() and not full_rect(splats)
            and env("GSCREAM_SORT_FUSED") != "1" and capacity % 1024 == 0):
        return bin_instances_pallas(splats, opacity, colors, unc, capacity,
                                    width, height, TILE_W, TILE_H)
    return bin_instances(splats, capacity, width, height, TILE_W, TILE_H,
                         precise)


def render_tiled(means3d, scales, rots, colors, opacity, unc, camera, bg,
                 capacity: int = 2 ** 21, scale_modifier: float = 1.0):
    """preprocess → bin → rasterize (rasterize_tiled.py:1295-1324).
    Returns (TiledOut, aux): ``aux`` holds the splats' ``radius``, the
    binning's ``num_instances`` (its :func:`~.binning.overflow_demand`,
    to compare with ``capacity``: an overflow is reported, never
    silent), ``capacity`` and the ``splats``."""
    splats = preprocess(means3d, scales, rots, camera.w2c, camera.full_proj,
                        camera.width, camera.height, camera.tan_fovx,
                        camera.tan_fovy, scale_modifier, tile_w=TILE_W,
                        tile_h=TILE_H, opacity=opacity)
    with torch.no_grad():
        binning = build_binning(splats, opacity, colors, unc, capacity,
                                camera.width, camera.height)
    out = rasterize_tiled(splats.mean2d, splats.conic, opacity, colors,
                          splats.depth, unc, binning, bg, camera.width,
                          camera.height)
    aux = {"radius": splats.radius,
           "num_instances": overflow_demand(binning),
           "capacity": capacity, "splats": splats}
    return out, aux
