"""Mean squared distance to the k nearest neighbours, the scale
initialization of `create_from_pcd` (port of langsplatv2_tpu/ops/knn.py).

The `simple_knn._C.distCUDA2(points) -> [N]` contract (reference
scene/gaussian_model.py:194-195): the mean squared distance from each point
to its 3 nearest other points. Exact, by chunked pairwise distances in the
JAX package's |a|^2 - 2 a.b + |b|^2 form (a matrix product per chunk), so
the two agree to rounding; chunking bounds memory at [chunk, N]. Runs once
per scene; the JAX version is not Pallas either.
"""
from __future__ import annotations

import torch


def mean_sq_dist_knn(points: torch.Tensor, k: int = 3,
                     chunk: int = 2048) -> torch.Tensor:
    """[N, 3] -> [N] mean squared distance to the k nearest neighbours
    (excluding self)."""
    n = points.shape[0]
    sq = (points ** 2).sum(-1)
    cols = torch.arange(n, device=points.device)
    out = torch.empty(n, dtype=points.dtype, device=points.device)
    for s in range(0, n, chunk):
        block = points[s:s + chunk]
        d2 = sq[s:s + chunk, None] - 2.0 * (block @ points.T) + sq[None, :]
        d2 = torch.clamp(d2, min=0.0)
        rows = torch.arange(s, s + block.shape[0], device=points.device)
        d2 = torch.where(rows[:, None] == cols[None, :], torch.inf, d2)
        out[s:s + chunk] = torch.topk(d2, k, dim=1, largest=False).values.mean(1)
    return out


def mean_sq_dist_3nn(points: torch.Tensor) -> torch.Tensor:
    """distCUDA2 drop-in."""
    return mean_sq_dist_knn(points, k=3)
