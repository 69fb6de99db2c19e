"""K-nearest-neighbor mean squared distance (counterpart of
``gscream_tpu/ops/knn.py``).

Per point, the mean of the squared distances to its 3 nearest neighbors
(``simple_knn.cu:180-182``), used for the initial anchor log-scale.  An
exact blocked sweep: ``torch.cdist`` of a block of rows against all
points, then ``topk``.  Self-matches are excluded by index, so duplicate
points count as genuine neighbors, as in the reference.
"""
from __future__ import annotations

import torch


def mean_knn_sq_dist(points: torch.Tensor, k: int = 3,
                     block: int = 1024) -> torch.Tensor:
    """(N,3) → (N,) mean squared distance to the k nearest neighbors."""
    n = points.shape[0]
    pts = points.to(torch.float32)
    out = torch.empty(n, dtype=torch.float32, device=points.device)
    kk = min(k, max(n - 1, 1))
    for s in range(0, n, block):
        rows = pts[s:s + block]
        d = torch.cdist(rows, pts).square_()
        idx = torch.arange(s, s + rows.shape[0], device=points.device)
        d[torch.arange(rows.shape[0], device=points.device), idx] = float("inf")
        out[s:s + block] = d.topk(kk, dim=1, largest=False).values.mean(1)
    return out


def estimate_voxel_size(points: torch.Tensor) -> torch.Tensor:
    """Median mean-3NN squared distance: the reference's automatic voxel
    size (gaussian_model.py:305-312, ``kthvalue(N/2)`` of ``distCUDA2``;
    JAX knn.py:53)."""
    d = mean_knn_sq_dist(points)
    n = d.shape[0]
    return torch.sort(d).values[(n // 2) - 1 if n % 2 == 0 else n // 2]
