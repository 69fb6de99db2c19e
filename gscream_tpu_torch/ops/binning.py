"""Tile binning: per-gaussian tile rects → depth-sorted per-tile instance
lists (counterpart of ``gscream_tpu/ops/binning.py``).

The default mode is **row-tight** emission (each tile row of a rect
emits the x-extent of the α ≥ 1/255 iso-ellipse, so the preprocess must
have run with ``opacity=``) in the **precise** order, a stable sort on
(tile, depth bits) — the reference's 64-bit radix key
(``rasterizer_impl.cu:306-314``).  The steps:

1. K5 (:func:`~.emission.expand_gauss_rows`), one kernel from the splats:
   each gaussian's rect height and its range of row-table slots (the
   prefix sum of the heights), the row table, each row's first instance
   slot (the prefix sum of the row widths), each gaussian's emission
   offset, and the row and instance totals;
2. K6 (:func:`~.emission.expand_rows`) writes the instance slots;
3. one stable ``torch.sort`` on ``tile << 32 | depth_bits`` (depth is at
   least 0.2, so its float32 bits are a positive int32 that orders like
   the float), then ``torch.searchsorted`` for the tile ranges.

The JAX package's other modes, each read per call:

* **full-rect** emission (splats without ``t_iso``, from a preprocess
  without ``opacity=`` or under ``GSCREAM_TIGHT_CULL=0``, or
  ``GSCREAM_ROW_TIGHT=0``; JAX :489-531): every tile of each rect, in
  row-major order.  JAX computes it in XLA, outside any Pallas kernel,
  and so does the port, in torch ops: the exclusive prefix of the rect
  areas, the slot → gaussian map by a scatter-max of each gaussian's id
  at its first slot and a running max, one row gather.  ``num_rows`` is
  0 and the row table is not used.
* ``precise=False`` (JAX :549-561): where the grid has fewer than 2,047
  tiles, one stable sort on the int32 key ``tile << 20 | (depth_bits >>
  11) & 0xFFFFF`` (the depth's top 20 bits: instances closer in depth
  than that blend in emission order); the precise sort otherwise.
* ``GSCREAM_SORT_FUSED=1`` (JAX :299-312, :537-547) sorts on (tile,
  per-scene depth rank), which gives the precise sort's order bit for
  bit (JAX's docstring, :252-261): the port sorts precisely.
* ``GSCREAM_ROW_RATIO`` (JAX :52, read at import there): instance slots
  per row-table slot, an integer ≥ 1, default :data:`ROW_RATIO`.

:func:`emission_counts` is step 1 counting only, one launch, or step 1
itself at a given row table (the rect areas' sum in full-rect mode).

The capacity is fixed by the caller.  Overflow is reported, never silent:
trailing instances (highest gaussian indices in emission order) are
dropped deterministically, ``num_instances``/``num_rows`` report the
demand, and the row table holds ``capacity // row_ratio()`` rows —
compare :func:`overflow_demand` with the capacity.  Every index field is
bit-equal to the JAX package's XLA build at the same capacity over the
live instances (and everywhere in full-rect mode).

:func:`bin_instances_pallas` (``GSCREAM_EMIT=pallas``) builds the same
binning in five stages: A compacts the emitting gaussians, K9a
(:func:`~.emission.expand1`) expands them to tile rows with their
attributes, C compacts the non-empty rows, K9b
(:func:`~.emission.expand2`) expands those to whole instance records, and
E is step 5, carrying the records into the dense ``cols16`` columns.  No
stage synchronises with the host: the compactions are stable sorts of a
flag.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from .emission import (DEPTH_INVALID, NO_CLAMP, _source_of, count_emission,
                       exclusive_with_total, expand1, expand2,
                       expand_gauss_rows, expand_rows, rect_heights)
from .projection import Splats

# instance slots per row-table slot (the row table has capacity //
# row_ratio() rows): the JAX package's default, which GSCREAM_ROW_RATIO
# overrides
ROW_RATIO = 2
KE = 256          # bin_instances_pallas: capacity granularity
QUANT_TILES = 2047    # precise=False packs the tile into 11 bits below this


def row_ratio() -> int:
    """``GSCREAM_ROW_RATIO`` as the JAX package reads it (binning.py:52):
    an integer, at least 1, :data:`ROW_RATIO` when unset."""
    return max(int(os.environ.get("GSCREAM_ROW_RATIO", str(ROW_RATIO))), 1)


def row_table_size(capacity: int) -> int:
    """Row-table length used by row-tight emission at ``capacity``."""
    return capacity // row_ratio()


def full_rect(splats) -> bool:
    """True where the binning emits whole rects: splats without ``t_iso``
    or ``GSCREAM_ROW_TIGHT=0`` (binning.py:225, :391-392)."""
    return splats.t_iso is None or os.environ.get("GSCREAM_ROW_TIGHT") == "0"


class Binning(NamedTuple):
    gauss_id: torch.Tensor    # (capacity,) int32 source gaussian per slot
    tile_id: torch.Tensor     # (capacity,) int32 sorted tile per slot
                              # (num_tiles = invalid)
    tile_start: torch.Tensor  # (num_tiles,) int32 first slot of each tile
    tile_count: torch.Tensor  # (num_tiles,) int32 instances in each tile
    num_instances: torch.Tensor  # () int32 total emitted (may exceed
                                 # capacity!)
    emit_slot: torch.Tensor   # (capacity,) int32 emission index of each
                              # sorted slot
    offsets: torch.Tensor     # (N+1,) int32 emission range starts per
                              # gaussian
    num_rows: torch.Tensor    # () int32 row-table demand (may exceed
                              # capacity // ROW_RATIO!)
    cols16: Optional[torch.Tensor] = None
    # optional (16, capacity) float32 dense sorted instance records from
    # the Pallas-emission build (:func:`bin_instances_pallas`);
    # ``pack_instance_data`` transposes them into records (K8).  (JAX's
    # ``attrs``, the attributes carried through the sort under
    # GSCREAM_ATTRS_PAYLOAD=1, hold what ``pack_instance_data`` gathers,
    # so the port gathers them there in every mode.)


def overflow_demand(binning: Binning) -> torch.Tensor:
    """Smallest capacity at which this emission would NOT overflow:
    instances need ``capacity >= num_instances``, the row table
    ``capacity >= row_ratio() * num_rows`` (``num_rows`` is 0 in
    full-rect mode)."""
    return torch.maximum(binning.num_instances,
                         row_ratio() * binning.num_rows)


def num_tiles(width: int, height: int, tile_w: int, tile_h: int) -> int:
    return (-(-width // tile_w)) * (-(-height // tile_h))


def _splat_fields(splats: Splats):
    """The splat fields K5 reads, in its argument order."""
    if splats.t_iso is None:
        raise ValueError("row-tight emission needs the splats' t_iso: run "
                         "preprocess with opacity=")
    return (splats.radius.contiguous(), splats.rect_min.contiguous(),
            splats.rect_max.contiguous(), splats.mean2d.contiguous(),
            splats.conic.contiguous(), splats.t_iso.contiguous(),
            splats.depth.contiguous())


def emission_counts(splats: Splats, tile_w: int, tile_h: int,
                    row_cap: Optional[int] = None):
    """(num_instances, num_rows) that :func:`bin_instances` would emit.
    In full-rect mode (:func:`full_rect`) the sum of the visible
    gaussians' rect areas and 0 (binning.py:225-229).  Without
    ``row_cap``, one counting launch (:func:`~.emission.
    count_emission`) that needs no row table; with it, K5 at a row table
    of ``row_cap`` slots, which must hold every rect row (size it from
    ``num_rows``, which is exact either way) or the instance count
    under-reports.  The counts do not depend on the tile grid's width, so
    a unit ``grid_x`` serves."""
    if full_rect(splats):
        area = _rect_areas(splats)
        return (torch.sum(area, dtype=torch.int32),
                torch.zeros((), dtype=torch.int32, device=area.device))
    fields = _splat_fields(splats)
    if row_cap is None:
        counts = count_emission(*fields, tile_w, tile_h)
    else:
        counts = expand_gauss_rows(*fields, max(row_cap, 1), NO_CLAMP,
                                   tile_w, tile_h, 1).counts
    return counts[1], counts[0]


def sort_instances(tile, depth_bits, n_tiles: int, precise: bool = True):
    """Step 3: one stable sort of the instance slots on ``tile << 32 |
    depth_bits`` → (sorted tile (capacity,) int32, the sort order (the
    emission index of each sorted slot), tile_start and tile_count
    (n_tiles,) int32 by ``searchsorted``).  Invalid slots carry ``tile =
    n_tiles``.  ``precise=False`` on a grid of fewer than 2,047 tiles
    sorts on the quantized int32 key of the module docstring instead
    (binning.py:549-561)."""
    if not precise and n_tiles < QUANT_TILES:
        valid = tile < n_tiles
        dq = (depth_bits >> 11) & 0xFFFFF      # depth bits are >= 0
        key = torch.where(valid, (tile << 20) | dq,
                          torch.full_like(tile, n_tiles << 20))
        key_s, order = torch.sort(key, stable=True)
        sorted_tile = key_s >> 20
    else:
        key = (tile.to(torch.int64) << 32) | depth_bits.to(torch.int64)
        key_s, order = torch.sort(key, stable=True)
        sorted_tile = (key_s >> 32).to(torch.int32)
    tids = torch.arange(n_tiles, dtype=torch.int32, device=tile.device)
    tile_start = torch.searchsorted(sorted_tile, tids, side="left")
    tile_end = torch.searchsorted(sorted_tile, tids, side="right")
    return (sorted_tile, order, tile_start.to(torch.int32),
            (tile_end - tile_start).to(torch.int32))


def _rect_areas(splats: Splats) -> torch.Tensor:
    """(N,) int32 tiles of each visible gaussian's rect (binning.py:226-228,
    :490-492)."""
    rw = splats.rect_max[:, 0] - splats.rect_min[:, 0]
    rh = splats.rect_max[:, 1] - splats.rect_min[:, 1]
    return torch.where(splats.radius > 0, rw * rh, torch.zeros_like(rw))


def _emit_full_rect(splats: Splats, capacity: int, grid_x: int,
                    n_tiles: int):
    """Full-rect emission (binning.py:489-531) → (tile, gaussian id, depth
    bits) per slot, invalid slots at ``(n_tiles, ·, 2^30)``, the
    per-gaussian emission offsets (N,) and the total (may exceed the
    capacity)."""
    dev = splats.depth.device
    i32 = torch.int32
    area = _rect_areas(splats)
    offs = exclusive_with_total(area)
    offsets, total = offs[:-1], offs[-1]
    n = area.shape[0]
    first = torch.where(area > 0, offsets,
                        torch.full_like(offsets, capacity))
    gmap = _source_of(first, torch.arange(n, dtype=i32, device=dev),
                      capacity, dev)
    rmin = splats.rect_min
    rw = torch.clamp_min(splats.rect_max[:, 0] - rmin[:, 0], 1)
    # one row gather of the per-gaussian emission columns
    et = torch.stack([offsets, rmin[:, 0], rmin[:, 1], rw,
                      splats.depth.view(i32)], dim=1)[gmap]
    slot = torch.arange(capacity, dtype=i32, device=dev)
    local = slot - et[:, 0]
    tile = ((et[:, 2] + torch.div(local, et[:, 3], rounding_mode="floor"))
            * grid_x + et[:, 1] + torch.remainder(local, et[:, 3]))
    valid = slot < torch.clamp_max(total, capacity)
    tile = torch.where(valid, tile, torch.full_like(tile, n_tiles))
    depth_bits = torch.where(valid, et[:, 4],
                             torch.full_like(slot, DEPTH_INVALID))
    return tile, gmap.to(i32), depth_bits, offsets, total


def bin_instances(splats: Splats, capacity: int, width: int, height: int,
                  tile_w: int, tile_h: int, precise: bool = True) -> Binning:
    """Depth-sorted per-tile instance lists at a fixed ``capacity``
    (``gscream_tpu/ops/binning.py::bin_instances``: row-tight or
    full-rect emission, the precise or the quantized sort; module
    docstring)."""
    grid_x = -(-width // tile_w)
    n_tiles = num_tiles(width, height, tile_w, tile_h)
    if full_rect(splats):
        tile, gid, depth_bits, offsets, total = _emit_full_rect(
            splats, capacity, grid_x, n_tiles)
        sorted_tile, order, tile_start, tile_count = sort_instances(
            tile, depth_bits, n_tiles, precise)
        return Binning(
            gauss_id=gid[order], tile_id=sorted_tile, tile_start=tile_start,
            tile_count=tile_count, num_instances=total,
            emit_slot=order.to(torch.int32),
            offsets=torch.clamp_max(torch.cat([offsets, total[None]]),
                                    capacity),
            num_rows=torch.zeros_like(total))
    row_cap = row_table_size(capacity)
    if row_cap < 1:
        raise ValueError(f"capacity {capacity} holds no row-table row "
                         f"(row ratio {row_ratio()})")

    table = expand_gauss_rows(*_splat_fields(splats), row_cap, capacity,
                              tile_w, tile_h, grid_x)
    inst = expand_rows(table.rows, table.ioffs, table.counts, capacity,
                       n_tiles)
    sorted_tile, order, tile_start, tile_count = sort_instances(
        inst[0], inst[2], n_tiles, precise)
    return Binning(gauss_id=inst[1][order],
                   tile_id=sorted_tile,
                   tile_start=tile_start,
                   tile_count=tile_count,
                   num_instances=table.counts[1],
                   emit_slot=order.to(torch.int32),
                   offsets=table.offsets,
                   num_rows=table.counts[0])


def _compact_order(keep: torch.Tensor) -> torch.Tensor:
    """Positions with ``keep`` first, each part in its original order: a
    stable sort of the drop flag (no host synchronisation)."""
    return torch.sort((~keep).to(torch.int32), stable=True).indices


def bin_instances_pallas(splats: Splats, opacity, colors, unc,
                         capacity: int, width: int, height: int,
                         tile_w: int, tile_h: int) -> Binning:
    """Row-tight emission through EXPAND1/EXPAND2
    (``gscream_tpu/ops/emission.py::bin_instances_pallas``, :514-639).

    Returns a :class:`Binning` whose index fields equal
    :func:`bin_instances`' over the live prefix and whose ``cols16`` holds
    the (16, capacity) float32 records in sorted order
    (``pack_instance_data``'s, lanes 14-15 and the slots past the live
    instances zero).  ``capacity`` must be a multiple of 256; the row
    table holds ``max(ceil(capacity // row_ratio() / 256)·256, 256)``
    rows.
    Requires ``splats.t_iso`` (tight culling)."""
    if splats.t_iso is None:
        raise ValueError("bin_instances_pallas requires tight culling "
                         "(splats.t_iso); use bin_instances instead")
    if capacity % KE:
        raise ValueError(f"capacity {capacity} not a multiple of {KE}")
    grid_x = -(-width // tile_w)
    n_tiles = num_tiles(width, height, tile_w, tile_h)
    row_cap = max(-(-row_table_size(capacity) // KE) * KE, KE)
    dev = splats.depth.device
    i32 = torch.int32

    # --- stage A: compact the emitting gaussians (stable: original order)
    rmin, rmax = splats.rect_min, splats.rect_max
    rect_h = rect_heights(splats.radius, rmin, rmax)
    row_offs = exclusive_with_total(rect_h)
    order_a = _compact_order(rect_h > 0)
    ro = exclusive_with_total(rect_h[order_a])
    gi = torch.stack([order_a.to(i32), rmin[order_a, 1], rmin[order_a, 0],
                      rmax[order_a, 0]], dim=1)
    gf = torch.stack([splats.mean2d[:, 0], splats.mean2d[:, 1],
                      splats.conic[:, 0], splats.conic[:, 1],
                      splats.conic[:, 2], 2.0 * splats.t_iso, splats.depth,
                      opacity, colors[:, 0], colors[:, 1], colors[:, 2],
                      unc], dim=1)[order_a].contiguous()
    idx, attr = expand1(ro, gi, gf, row_cap, tile_w, tile_h)

    # --- stage C: compact the non-empty rows (stable: emission order)
    kept = idx[3] > 0
    order_c = _compact_order(kept)
    io = exclusive_with_total(idx[3, order_c])
    total_inst = io[row_cap]
    rec, ids = expand2(io, idx[:3, order_c].contiguous(),
                       attr[:, order_c].contiguous(), capacity, tile_w,
                       tile_h, grid_x, n_tiles)

    # per-gaussian emission offsets (:586-603): the instance offset at
    # each gaussian's first row, by that row's rank among the kept rows
    # (an empty row ranks as the next kept one).  Stage A keeps the
    # gaussians in order, so the row prefix in gaussian order locates each
    # first row, and a gaussian without rows takes the next one's start.
    rank = exclusive_with_total(kept.to(i32))
    goffs = io[rank[torch.clamp_max(row_offs[:-1], row_cap).long()].long()]
    offsets = torch.clamp_max(torch.cat([goffs, total_inst.reshape(1)]),
                              capacity)

    # --- stage E: the (tile, depth bits) sort, carrying the records
    slot = torch.arange(capacity, dtype=i32, device=dev)
    valid = slot < torch.clamp_max(total_inst, capacity)
    depth_bits = torch.where(valid, rec[4].view(i32),
                             torch.full_like(slot, DEPTH_INVALID))
    sorted_tile, order, tile_start, tile_count = sort_instances(
        ids[0], depth_bits, n_tiles)
    cols16 = torch.zeros((16, capacity), dtype=torch.float32, device=dev)
    cols16[:14] = rec[:, order]
    return Binning(gauss_id=ids[1, order], tile_id=sorted_tile,
                   tile_start=tile_start, tile_count=tile_count,
                   num_instances=total_inst, emit_slot=order.to(i32),
                   offsets=offsets, num_rows=row_offs[-1], cols16=cols16)
