"""Instance records → dense gradient columns: K4 (counterpart of
``gscream_tpu/ops/shuffle.py::unpack_columns``).

The JAX package packs 8 instances of 16 lanes into each 128-lane row and
unpacks with ``cols[j, 8r+φ] = packed[r, 16φ+j]``.  The port's packed
array is the (n, 16) record array itself — a (n/8, 128) view of the same
memory — so the function is the float32 transpose ``cols[j, i] =
rec[i, j]``: (n, 16) → (16, n).  :func:`unpack_columns` launches the CUDA
kernel (``csrc/shuffle.cu``) for CUDA tensors and runs
:func:`unpack_columns_plain` for CPU tensors.  Both copy values, so they
are bit-equal.
"""
from __future__ import annotations

import torch

from . import cuda_build as cb

ILANES = 16       # floats per instance record


def unpack_columns_plain(rec: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: the 16 record lanes stacked as rows."""
    return torch.stack([rec[:, j] for j in range(ILANES)])


def unpack_columns(rec: torch.Tensor) -> torch.Tensor:
    """K4: (n, 16) float32 records → (16, n) float32 columns."""
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
