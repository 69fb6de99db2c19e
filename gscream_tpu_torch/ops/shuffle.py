"""Instance records ↔ dense columns: K4 and K8 (counterparts of
``gscream_tpu/ops/shuffle.py::unpack_columns`` and ``::pack_columns``).

The JAX package packs 8 instances of 16 lanes into each 128-lane row:
``out[r, 16φ+j] = cols[j, 8r+φ]`` (pack) and its inverse ``cols[j, 8r+φ]
= packed[r, 16φ+j]`` (unpack).  The port's packed array is the (n, 16)
record array itself — a (n/8, 128) view of the same memory — so the two
are float32 transposes: K4 ``cols[j, i] = rec[i, j]``, (n, 16) → (16, n),
and K8 ``rec[i, j] = cols[j, i]``, (16, n) → (n, 16).  Each wrapper
launches its CUDA kernel (``csrc/shuffle.cu``) for CUDA tensors and runs
its plain version for CPU tensors.  K4 feeds only the default gradient
flow (``reduce_grads_cm``), so it also applies that flow's sanitize
(rasterize_tiled.py:1073) as it stores: a non-finite value becomes 0.
Both kernels copy or zero values, so kernel and plain version are
bit-equal.
"""
from __future__ import annotations

import torch

from . import cuda_build as cb

ILANES = 16       # floats per instance record


def unpack_columns_plain(rec: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: the 16 record lanes stacked as rows,
    non-finite values zeroed."""
    cols = torch.stack([rec[:, j] for j in range(ILANES)])
    return torch.where(torch.isfinite(cols), cols, 0.0)


def unpack_columns(rec: torch.Tensor) -> torch.Tensor:
    """K4: (n, 16) float32 records → (16, n) float32 columns, each
    non-finite value (NaN, ±inf) written as 0."""
    if rec.device.type == "cpu":
        return unpack_columns_plain(rec)
    cb.check(rec, "rec", torch.float32, (None, ILANES))
    n = rec.shape[0]
    cols = torch.empty((ILANES, n), dtype=torch.float32, device=rec.device)
    fn = cb.function("shuffle", "gs_unpack_columns", "pipp")
    cb.raise_on_error(fn(cb.ptr(rec), n, cb.ptr(cols), cb.stream_of(rec)),
                      "unpack_columns")
    unpack_columns.launches += 1
    return cols


unpack_columns.launches = 0


def pack_columns_plain(cols: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: the 16 column rows stacked as record lanes."""
    return torch.stack([cols[j] for j in range(ILANES)], dim=1)


def pack_columns(cols: torch.Tensor) -> torch.Tensor:
    """K8: (16, n) float32 columns → (n, 16) float32 records."""
    if cols.device.type == "cpu":
        return pack_columns_plain(cols)
    cb.check(cols, "cols", torch.float32, (ILANES, None))
    n = cols.shape[1]
    rec = torch.empty((n, ILANES), dtype=torch.float32, device=cols.device)
    fn = cb.function("shuffle", "gs_pack_columns", "pipp")
    cb.raise_on_error(fn(cb.ptr(cols), n, cb.ptr(rec), cb.stream_of(cols)),
                      "pack_columns")
    pack_columns.launches += 1
    return rec


pack_columns.launches = 0
