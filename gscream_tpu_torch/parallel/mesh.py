"""The (data, tiles) mesh of ranks (counterpart of
``gscream_tpu/parallel/mesh.py``).

* ``data``  — views per step: each data row renders its own view, and
  gradients and statistics are reduced over the rows;
* ``tiles`` — bands of tile rows of one view: each rank of a row
  rasterizes its band, and the band partials are reduced over the row.

One process drives one card, so a mesh of ``data × tiles`` ranks needs a
``torch.distributed`` world of exactly that size.  Rank ``r`` sits at
``(data_index, band) = divmod(r, tiles)``, the row-major reshape of the
JAX package's ``make_mesh``.  Every rank belongs to one tile group (the
ranks of its data row) and one data group (the ranks of its band
column).  ``Mesh(1, 1)`` is a single process and needs no process group.
"""
from __future__ import annotations

from typing import List, NamedTuple

DATA_AXIS = "data"
TILE_AXIS = "tiles"


class Mesh(NamedTuple):
    data: int = 1
    tiles: int = 1
    rank: int = 0
    tile_group: object = None   # this rank's data row; None when tiles == 1
    data_group: object = None   # this rank's band column; None when data == 1
    world_group: object = None  # every rank; None when the mesh is 1 × 1

    @property
    def shape(self):
        return {DATA_AXIS: self.data, TILE_AXIS: self.tiles}

    @property
    def size(self) -> int:
        return self.data * self.tiles

    @property
    def data_index(self) -> int:
        return self.rank // self.tiles

    @property
    def band(self) -> int:
        return self.rank % self.tiles


def tile_ranks(data_index: int, tiles: int) -> List[int]:
    return [data_index * tiles + b for b in range(tiles)]


def data_ranks(band: int, data: int, tiles: int) -> List[int]:
    return [d * tiles + band for d in range(data)]


def make_mesh(data: int = 1, tiles: int = 1) -> Mesh:
    """The mesh over the ``torch.distributed`` world, which must hold
    exactly ``data · tiles`` ranks (a single process for 1 × 1).  Every
    rank calls this with the same shape: it creates every row's and
    every column's process group, in one order."""
    import torch.distributed as dist
    need = data * tiles
    if data < 1 or tiles < 1:
        raise ValueError(f"mesh {data}x{tiles}: both axes must be >= 1")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"mesh {data}x{tiles} needs {need} processes (one "
                         f"per card), the world has {world}")
    if need == 1:
        return Mesh(data, tiles)
    rank = dist.get_rank()
    d, b = divmod(rank, tiles)
    rows = [dist.new_group(tile_ranks(i, tiles)) if tiles > 1 else None
            for i in range(data)]
    cols = [dist.new_group(data_ranks(j, data, tiles)) if data > 1 else None
            for j in range(tiles)]
    return Mesh(data, tiles, rank, rows[d], cols[b], dist.group.WORLD)


def auto_shape(n: int):
    """(data, tiles) of ``n`` ranks, tiles first from (8, 4, 2, 1)."""
    tiles = next(t for t in (8, 4, 2, 1) if n % t == 0)
    return n // tiles, tiles


def auto_mesh() -> Mesh:
    """The mesh over the whole world, factored by :func:`auto_shape`."""
    import torch.distributed as dist
    return make_mesh(*auto_shape(
        dist.get_world_size() if dist.is_initialized() else 1))
