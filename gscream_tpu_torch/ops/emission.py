"""Row-tight instance expansion: K5 and K6 (counterparts of the Pallas
kernels ``gscream_tpu/ops/emission.py::_expand_gauss_kernel`` and
``::_expand_rows_kernel``), and K9's EXPAND1 and EXPAND2
(``::_expand1_kernel``, ``::_expand2_kernel``) of the Pallas-emission
build :func:`~.binning.bin_instances_pallas`.

Stage 1 (K5, :func:`expand_gauss_rows`): the splats → a table of tile
rows ``(tile_base, gid, depth_bits, w_row)``, gaussian-major and
row-major, where ``w_row`` is the width in tiles of that row's covering of
the α ≥ 1/255 iso-ellipse (``binning._row_extents`` of the JAX package),
with everything around it that the XLA build computes in separate ops:
each gaussian's rect height and their prefix sum (its rows), the prefix
sum of ``w_row`` (each row's first instance slot), the per-gaussian
emission offsets and the two totals.  One kernel, one pass over chunks of
512 gaussians chained by two decoupled look-backs (``csrc/emission.cu``).
:func:`count_emission` is the same pass counting only.

Stage 2 (K6, :func:`expand_rows`): the row table → per-instance
``(tile, gid, depth_bits)`` slots, slots at or past ``min(total,
capacity)`` invalid (``tile = n_tiles``); each CTA of 1,024 slots stages
the rows it spans in shared memory.

Each wrapper launches its CUDA kernel (``csrc/emission.cu``) for CUDA
tensors and runs its plain PyTorch version for CPU tensors; there is no
fallback from one to the other.  The plain versions are the XLA row-tight
build of the JAX package written in torch (``binning.py:167-213`` and
``:465-490``): a boundary scatter-max plus ``cummax`` maps each output
slot to its source, then a gather.  Kernel and plain version are
bit-equal: both evaluate the same float32 expressions one rounding at a
time (the kernel computes each gaussian's share of them once), every scan
is an integer sum, and both write zeros (K5) or ``(n_tiles, 0, 2^30)``
(K6) to the slots past the live total, where the JAX package leaves
don't-care values.

K9a (:func:`expand1`) expands the compacted emitting gaussians to tile
rows with their attributes, K9b (:func:`expand2`) the compacted non-empty
rows to whole instance records.  They are K5 and K6 with the payload
carried along, in the first design (one thread per output slot, a binary
search of the caller's prefix sum), bit-equal with their plain versions;
every index stays an int32 in a tensor of its own, where the TPU kernels
carried indices as float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import cuda_build as cb

DEPTH_INVALID = 1 << 30     # depth key of an invalid instance slot
K5_CHUNK = 512              # gaussians per K5 chunk (kChunk of emission.cu)
NO_CLAMP = (1 << 31) - 1    # a capacity that clamps no offset


class RowTable(NamedTuple):
    """K5's outputs."""
    rows: torch.Tensor      # (4, row_cap) int32 tile_base, gid,
                            # depth_bits, w_row; zeros past the live rows
    ioffs: torch.Tensor     # (row_cap,) int32 exclusive prefix of w_row
                            # over the live rows, zeros past them
    offsets: torch.Tensor   # (N+1,) int32 per-gaussian emission starts,
                            # the total last, clamped to the capacity
    counts: torch.Tensor    # (2,) int32 [row demand (may exceed row_cap),
                            # instances of the rows below row_cap (may
                            # exceed the capacity)]


def exclusive_with_total(x: torch.Tensor) -> torch.Tensor:
    """(n,) int32 → (n+1,) int32 exclusive prefix sum, total appended."""
    out = torch.zeros(x.shape[0] + 1, dtype=torch.int32, device=x.device)
    out[1:] = torch.cumsum(x, 0, dtype=torch.int32)
    return out


def rect_heights(radius, rect_min, rect_max) -> torch.Tensor:
    """(N,) int32 rect heights in tile rows, 0 for a gaussian that emits
    nothing (``binning.py:178-185``)."""
    return torch.where((radius > 0) & (rect_max[:, 0] > rect_min[:, 0]),
                       rect_max[:, 1] - rect_min[:, 1],
                       torch.zeros_like(rect_min[:, 1]))


def _row_extents(rslot, r_off, r_ymin, r_xmin, r_xmax, mx, my, ca, cb_,
                 cc, t2, total_rows, tile_w: int, tile_h: int):
    """Per tile-row [txmin, txmax) covering of the α ≥ 1/255 iso-ellipse
    (``gscream_tpu/ops/binning.py::_row_extents``, expression for
    expression; see there for the derivation and the ¼-px / 1-px guards).
    ``tile_w`` must be a power of two: PyTorch divides by a scalar as a
    multiply by its reciprocal on the GPU, exact only for powers of two."""
    ty = r_ymin + (rslot - r_off)
    lo = ty.float() * float(tile_h) - my - 0.25
    hi = lo + float(tile_h - 1) + 0.5
    q = ca * cc - cb_ * cb_
    qs = torch.clamp_min(q, 1e-20)
    cs = torch.clamp_min(cc, 1e-20)
    a_s = torch.clamp_min(ca, 1e-20)
    hx = torch.sqrt(torch.clamp_min(t2 * cs / qs, 0.0))
    hy = torch.sqrt(torch.clamp_min(t2 * a_s / qs, 0.0))
    lc = torch.maximum(lo, -hy)
    uc = torch.minimum(hi, hy)

    def sqrt_d(dy):
        return torch.sqrt(torch.clamp_min(t2 * ca - q * dy * dy, 0.0))

    ncb = -cb_
    dxp_l = (ncb * lc + sqrt_d(lc)) / a_s
    dxp_u = (ncb * uc + sqrt_d(uc)) / a_s
    dxm_l = (ncb * lc - sqrt_d(lc)) / a_s
    dxm_u = (ncb * uc - sqrt_d(uc)) / a_s
    dyv = ncb * torch.sqrt(torch.clamp_min(t2 / (cs * qs), 0.0))
    xhi = torch.maximum(dxp_l, dxp_u)
    xhi = torch.where((dyv >= lc - 1.0) & (dyv <= uc + 1.0),
                      torch.maximum(xhi, hx), xhi)
    xlo = torch.minimum(dxm_l, dxm_u)
    xlo = torch.where((-dyv >= lc - 1.0) & (-dyv <= uc + 1.0),
                      torch.minimum(xlo, -hx), xlo)

    txmin = torch.maximum(torch.floor((mx + xlo - 0.25) / tile_w),
                          r_xmin.float()).to(torch.int32)
    txmax = torch.minimum(torch.floor((mx + xhi + 0.25) / tile_w) + 1.0,
                          r_xmax.float()).to(torch.int32)
    tight = t2 > 0.0
    txmin = torch.where(tight, txmin, r_xmin)
    txmax = torch.where(tight, txmax, r_xmax)
    w_row = torch.clamp_min(txmax - txmin, 0)
    w_row = torch.where((rslot < total_rows) & ((lc <= uc) | ~tight),
                        w_row, torch.zeros_like(w_row))
    return ty, txmin, w_row


def _source_of(first, src_ids, n_out: int, device):
    """Output slot → source id: scatter-max each emitting source's id at
    its first slot (dropping slots ≥ n_out), then a running max."""
    keep = first < n_out
    marks = torch.zeros(n_out, dtype=torch.int32, device=device)
    marks.scatter_reduce_(0, first[keep].long(), src_ids[keep],
                          reduce="amax")
    return torch.cummax(marks, 0).values.long()


def expand_gauss_rows_plain(radius, rect_min, rect_max, mean2d, conic,
                            t_iso, depth, row_cap: int, capacity: int,
                            tile_w: int, tile_h: int,
                            grid_x: int) -> RowTable:
    """Plain version of K5; see :func:`expand_gauss_rows`."""
    dev = depth.device
    n = depth.shape[0]
    rect_h = rect_heights(radius, rect_min, rect_max)
    row_offs = exclusive_with_total(rect_h)
    total_rows = row_offs[n]
    gid = torch.arange(n, dtype=torch.int32, device=dev)
    rg = _source_of(torch.where(rect_h > 0, row_offs[:-1],
                                torch.full_like(rect_h, row_cap)),
                    gid, row_cap, dev)
    rslot = torch.arange(row_cap, dtype=torch.int32, device=dev)
    ty, txmin, w_row = _row_extents(
        rslot, row_offs[rg], rect_min[rg, 1], rect_min[rg, 0],
        rect_max[rg, 0], mean2d[rg, 0], mean2d[rg, 1], conic[rg, 0],
        conic[rg, 1], conic[rg, 2], 2.0 * t_iso[rg], total_rows, tile_w,
        tile_h)
    live = rslot < total_rows
    zero = torch.zeros_like(rslot)
    rows = torch.stack([
        torch.where(live, ty * grid_x + txmin, zero),
        torch.where(live, rg.to(torch.int32), zero),
        torch.where(live, depth.view(torch.int32)[rg], zero),
        w_row,
    ])
    # each row's first instance slot; a gaussian's emission start is that
    # of its first row, and one without rows takes the next start
    # (binning.py:485-490)
    ioffs_ext = exclusive_with_total(w_row)
    offsets = torch.clamp_max(
        ioffs_ext[torch.clamp_max(row_offs, row_cap).long()], capacity)
    return RowTable(rows=rows, ioffs=torch.where(live, ioffs_ext[:-1], zero),
                    offsets=offsets,
                    counts=torch.stack([total_rows, ioffs_ext[row_cap]]))


def _check_splats(radius, rect_min, rect_max, mean2d, conic, t_iso, depth):
    n = depth.shape[0]
    for t, nm, dt, shp in ((radius, "radius", torch.int32, (n,)),
                           (rect_min, "rect_min", torch.int32, (n, 2)),
                           (rect_max, "rect_max", torch.int32, (n, 2)),
                           (mean2d, "mean2d", torch.float32, (n, 2)),
                           (conic, "conic", torch.float32, (n, 3)),
                           (t_iso, "t_iso", torch.float32, (n,)),
                           (depth, "depth", torch.float32, (n,))):
        cb.check(t, nm, dt, shp)
    return n


def expand_gauss_rows(radius, rect_min, rect_max, mean2d, conic, t_iso,
                      depth, row_cap: int, capacity: int, tile_w: int,
                      tile_h: int, grid_x: int) -> RowTable:
    """K5: the splats → the :class:`RowTable` of a row table of
    ``row_cap`` (≥ 1) slots and ``capacity`` instance slots.

    The inputs are the :class:`~.projection.Splats` fields ``radius``
    (N,) int32, ``rect_min``/``rect_max`` (N, 2) int32, ``mean2d`` (N, 2),
    ``conic`` (N, 3), ``t_iso`` (N,) and ``depth`` (N,) float32.  Gaussian
    ``g`` emits its rect height in tile rows if ``radius > 0`` and its
    rect is not empty in x; it owns rows ``[row_offs[g], row_offs[g+1])``
    of the table (``row_offs`` the exclusive prefix sum of the heights),
    truncated at ``row_cap``.  ``rows`` holds ``[tile_base, gid,
    depth_bits, w_row]`` per row slot, ``ioffs`` the exclusive prefix sum
    of ``w_row`` (both zero past the live rows), ``offsets[g]`` the first instance slot of gaussian ``g``
    (that of its first row; one without rows takes the next start) with
    the total last, clamped to ``capacity``, and ``counts`` the row
    demand and the instance total of the rows below ``row_cap``.
    """
    if depth.device.type == "cpu":
        return expand_gauss_rows_plain(radius, rect_min, rect_max, mean2d,
                                       conic, t_iso, depth, row_cap,
                                       capacity, tile_w, tile_h, grid_x)
    if row_cap < 1:
        raise ValueError(f"row_cap {row_cap}: the row table needs a slot")
    n = _check_splats(radius, rect_min, rect_max, mean2d, conic, t_iso,
                      depth)
    dev = depth.device
    out = torch.empty(5 * row_cap + n + 3, dtype=torch.int32, device=dev)
    table = RowTable(rows=out[:4 * row_cap].view(4, row_cap),
                     ioffs=out[4 * row_cap:5 * row_cap],
                     offsets=out[5 * row_cap:5 * row_cap + n + 1],
                     counts=out[5 * row_cap + n + 1:])
    # the two look-back chains and the ticket, zero before every launch
    status = torch.zeros(2 * (-(-n // K5_CHUNK)) + 1, dtype=torch.int64,
                         device=dev)
    fn = cb.function("emission", "gs_expand_gauss_rows",
                     "pppppppiiiiiipppppp")
    rc = fn(cb.ptr(radius), cb.ptr(rect_min), cb.ptr(rect_max),
            cb.ptr(mean2d), cb.ptr(conic), cb.ptr(t_iso), cb.ptr(depth), n,
            row_cap, capacity, tile_w, tile_h, grid_x, cb.ptr(status),
            cb.ptr(table.rows), cb.ptr(table.ioffs), cb.ptr(table.offsets),
            cb.ptr(table.counts), cb.stream_of(depth))
    cb.raise_on_error(rc, "expand_gauss_rows")
    expand_gauss_rows.launches += 1
    return table


expand_gauss_rows.launches = 0


def count_emission_plain(radius, rect_min, rect_max, mean2d, conic, t_iso,
                         depth, tile_w: int, tile_h: int) -> torch.Tensor:
    """Plain version of :func:`count_emission`: the plain K5 at a row
    table that holds every row."""
    total_rows = int(rect_heights(radius, rect_min, rect_max).sum())
    return expand_gauss_rows_plain(radius, rect_min, rect_max, mean2d,
                                   conic, t_iso, depth, max(total_rows, 1),
                                   NO_CLAMP, tile_w, tile_h, 1).counts


def count_emission(radius, rect_min, rect_max, mean2d, conic, t_iso, depth,
                   tile_w: int, tile_h: int) -> torch.Tensor:
    """K5 counting only: the (2,) int32 ``[row demand, instances]`` that
    :func:`expand_gauss_rows` reports at a row table that holds every row,
    without the table (no truncation, nothing written but the counts)."""
    if depth.device.type == "cpu":
        return count_emission_plain(radius, rect_min, rect_max, mean2d,
                                    conic, t_iso, depth, tile_w, tile_h)
    n = _check_splats(radius, rect_min, rect_max, mean2d, conic, t_iso,
                      depth)
    counts = torch.zeros(2, dtype=torch.int32, device=depth.device)
    fn = cb.function("emission", "gs_count_emission", "pppppppiiipp")
    rc = fn(cb.ptr(radius), cb.ptr(rect_min), cb.ptr(rect_max),
            cb.ptr(mean2d), cb.ptr(conic), cb.ptr(t_iso), cb.ptr(depth), n,
            tile_w, tile_h, cb.ptr(counts), cb.stream_of(depth))
    cb.raise_on_error(rc, "count_emission")
    count_emission.launches += 1
    return counts


count_emission.launches = 0


def expand_rows_plain(rows, ioffs, counts, capacity: int,
                      n_tiles: int) -> torch.Tensor:
    """Plain version of K6; see :func:`expand_rows` (``row_cap`` ≥ 1)."""
    dev = rows.device
    row_cap = rows.shape[1]
    tile_base, rg, dep, w_row = rows[0], rows[1], rows[2], rows[3]
    rslot = torch.arange(row_cap, dtype=torch.int32, device=dev)
    row_of = _source_of(torch.where(w_row > 0, ioffs,
                                    torch.full_like(ioffs, capacity)),
                        rslot, capacity, dev)
    slot = torch.arange(capacity, dtype=torch.int32, device=dev)
    valid = slot < torch.clamp_max(counts[1], capacity)
    tile = tile_base[row_of] + (slot - ioffs[row_of])
    return torch.stack([
        torch.where(valid, tile, torch.full_like(tile, n_tiles)),
        torch.where(valid, rg[row_of], torch.zeros_like(tile)),
        torch.where(valid, dep[row_of], torch.full_like(tile,
                                                        DEPTH_INVALID)),
    ])


def expand_rows(rows, ioffs, counts, capacity: int,
                n_tiles: int) -> torch.Tensor:
    """K6: K5's (4, row_cap) row table, its (row_cap,) int32 ``ioffs`` and
    its (2,) ``counts`` → (3, capacity) int32 ``[tile, gid, depth_bits]``
    in emission order."""
    if rows.device.type == "cpu":
        return expand_rows_plain(rows, ioffs, counts, capacity, n_tiles)
    row_cap = rows.shape[1]
    cb.check(rows, "rows", torch.int32, (4, row_cap))
    cb.check(ioffs, "ioffs", torch.int32, (row_cap,))
    cb.check(counts, "counts", torch.int32, (2,))
    out = torch.empty((3, capacity), dtype=torch.int32, device=rows.device)
    fn = cb.function("emission", "gs_expand_rows", "pppiiipp")
    rc = fn(cb.ptr(ioffs), cb.ptr(rows), cb.ptr(counts), row_cap, capacity,
            n_tiles, cb.ptr(out), cb.stream_of(rows))
    cb.raise_on_error(rc, "expand_rows")
    expand_rows.launches += 1
    return out


expand_rows.launches = 0


# ---------------------------------------------------------------------------
# the Pallas-emission build (GSCREAM_EMIT=pallas)

def expand1_plain(ro, gi, gf, row_cap: int, tile_w: int, tile_h: int):
    """Plain version of K9a; see :func:`expand1`."""
    dev = gf.device
    n = gi.shape[0]
    total_rows = ro[n]
    src = _source_of(torch.where(ro[1:] > ro[:-1], ro[:-1],
                                 torch.full_like(ro[:-1], row_cap)),
                     torch.arange(n, dtype=torch.int32, device=dev), row_cap,
                     dev)
    rslot = torch.arange(row_cap, dtype=torch.int32, device=dev)
    i, f = gi[src], gf[src]
    ty, txmin, w_row = _row_extents(
        rslot, ro[src], i[:, 1], i[:, 2], i[:, 3], f[:, 0], f[:, 1],
        f[:, 2], f[:, 3], f[:, 4], f[:, 5], total_rows, tile_w, tile_h)
    live = rslot < total_rows
    zero = torch.zeros_like(rslot)
    idx = torch.stack([torch.where(live, i[:, 0], zero),
                       torch.where(live, ty, zero),
                       torch.where(live, txmin, zero), w_row])
    attr = torch.cat([f[:, :5], f[:, 6:]], dim=1).T
    return idx, torch.where(live, attr, torch.zeros_like(attr)).contiguous()


def expand1(ro, gi, gf, row_cap: int, tile_w: int, tile_h: int):
    """K9a, EXPAND1: the compacted emitting gaussians → the row table.

    ``ro`` (n+1,) int32 is the exclusive prefix sum of the compacted rect
    heights with the total appended; compacted gaussian ``c`` owns rows
    ``[ro[c], ro[c+1])``, truncated at ``row_cap``.  ``gi`` (n, 4) int32
    holds ``[gid, rect ymin, rect xmin, rect xmax]``, ``gf`` (n, 12)
    float32 ``[mx, my, ca, cb, cc, t2, depth, op, r, g, b, unc]``.
    Returns the (4, row_cap) int32 ``[gid, ty, txmin, w_row]`` (``w_row``
    as K5 computes it) and the (11, row_cap) float32 ``[mx, my, ca, cb,
    cc, depth, op, r, g, b, unc]`` of each row's gaussian; rows at or past
    the total hold zeros."""
    if gf.device.type == "cpu":
        return expand1_plain(ro, gi, gf, row_cap, tile_w, tile_h)
    n = gi.shape[0]
    cb.check(ro, "ro", torch.int32, (n + 1,))
    cb.check(gi, "gi", torch.int32, (n, 4))
    cb.check(gf, "gf", torch.float32, (n, 12))
    idx = torch.empty((4, row_cap), dtype=torch.int32, device=gf.device)
    attr = torch.empty((11, row_cap), dtype=torch.float32, device=gf.device)
    fn = cb.function("emission", "gs_expand1", "pppiiiippp")
    rc = fn(cb.ptr(ro), cb.ptr(gi), cb.ptr(gf), n, row_cap, tile_w, tile_h,
            cb.ptr(idx), cb.ptr(attr), cb.stream_of(gf))
    cb.raise_on_error(rc, "expand1")
    expand1.launches += 1
    return idx, attr


expand1.launches = 0


def expand2_plain(io, ri, rf, capacity: int, tile_w: int, tile_h: int,
                  grid_x: int, n_tiles: int):
    """Plain version of K9b; see :func:`expand2`.  The coefficients are
    ``pack_instance_data``'s expressions, one rounding per operation."""
    dev = rf.device
    row_cap = ri.shape[1]
    row_of = _source_of(torch.where(io[1:] > io[:-1], io[:-1],
                                    torch.full_like(io[:-1], capacity)),
                        torch.arange(row_cap, dtype=torch.int32, device=dev),
                        capacity, dev)
    slot = torch.arange(capacity, dtype=torch.int32, device=dev)
    valid = slot < torch.clamp_max(io[row_cap], capacity)
    ty = ri[1, row_of]
    tx = ri[2, row_of] + (slot - io[row_of])
    ox = (tx * tile_w).to(torch.float32)
    oy = (ty * tile_h).to(torch.float32)
    mx, my, ca, cb_, cc, depth, op, r, g, b, unc = rf[:, row_of]
    mxl = mx - ox
    myl = my - oy
    k0 = -0.5 * (ca * mxl * mxl + cc * myl * myl) - cb_ * mxl * myl
    k1 = ca * mxl + cb_ * myl
    k2 = cc * myl + cb_ * mxl
    rec = torch.stack([op, r, g, b, depth, unc, k0, k1, k2, -0.5 * ca,
                       -cb_, -0.5 * cc, ox - torch.round(mx),
                       oy - torch.round(my)])
    ids = torch.stack([
        torch.where(valid, ty * grid_x + tx, torch.full_like(tx, n_tiles)),
        torch.where(valid, ri[0, row_of], torch.zeros_like(tx))])
    return torch.where(valid, rec, torch.zeros_like(rec)), ids


def expand2(io, ri, rf, capacity: int, tile_w: int, tile_h: int,
            grid_x: int, n_tiles: int):
    """K9b, EXPAND2: the compacted non-empty rows → instance records in
    emission order.

    ``io`` (row_cap+1,) int32 is the exclusive prefix sum of the
    compacted ``w_row`` with the total appended; row ``r`` owns slots
    ``[io[r], io[r+1])``, truncated at ``capacity``.  ``ri`` (3, row_cap)
    int32 ``[gid, ty, txmin]`` and ``rf`` (11, row_cap) float32 are K9a's
    tables, compacted.  Returns the (14, capacity) float32 records ``[op,
    r, g, b, depth, unc, k0..k5, sx, sy]`` (``pack_instance_data``'s
    lanes 0-13) and the (2, capacity) int32 ``[tile, gid]``; slots at or
    past ``min(total, capacity)`` hold zeros and tile ``n_tiles``."""
    if rf.device.type == "cpu":
        return expand2_plain(io, ri, rf, capacity, tile_w, tile_h, grid_x,
                             n_tiles)
    row_cap = ri.shape[1]
    cb.check(io, "io", torch.int32, (row_cap + 1,))
    cb.check(ri, "ri", torch.int32, (3, row_cap))
    cb.check(rf, "rf", torch.float32, (11, row_cap))
    rec = torch.empty((14, capacity), dtype=torch.float32, device=rf.device)
    ids = torch.empty((2, capacity), dtype=torch.int32, device=rf.device)
    fn = cb.function("emission", "gs_expand2", "pppiiiiiippp")
    rc = fn(cb.ptr(io), cb.ptr(ri), cb.ptr(rf), row_cap, capacity, tile_w,
            tile_h, grid_x, n_tiles, cb.ptr(rec), cb.ptr(ids),
            cb.stream_of(rf))
    cb.raise_on_error(rc, "expand2")
    expand2.launches += 1
    return rec, ids


expand2.launches = 0
