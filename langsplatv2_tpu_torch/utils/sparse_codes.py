"""Sparse top-k codes over the codebook
(port of langsplatv2_tpu/utils/sparse_codes.py:17-99).

Top-k keeps `_topk_onehots`' order: value descending, lowest index first on
ties. The selection carries no gradient; `get_weights_and_indices`'
weights are a softmax over the gathered selected logits, so autograd gives
logits that were not selected exactly zero gradient (the JAX docstring's
contract, :63-72). The residual k-means codebook init is later work.
"""
from __future__ import annotations

import torch


def _topk_columns(y: torch.Tensor, k: int) -> list[torch.Tensor]:
    """Indices [N] of the k largest entries of each row of y [N, K], by
    iterative masked max with the lowest index winning a tie."""
    K = y.shape[1]
    iota = torch.arange(K, device=y.device)
    ym = y.detach().clone()
    cols = []
    for _ in range(k):
        is_max = ym == ym.max(dim=1, keepdim=True).values
        cmin = torch.where(is_max, iota, K).min(dim=1).values
        cols.append(cmin)
        ym.scatter_(1, cmin[:, None], float("-inf"))
    return cols


def softmax_to_topk_soft_code(logits: torch.Tensor, k: int) -> torch.Tensor:
    """[N, K] logits -> softmax, keep the top-k, renormalize (+1e-10)."""
    y = torch.softmax(logits, dim=1)
    mask = torch.zeros_like(y, dtype=torch.bool)
    for idx in _topk_columns(y, k):
        mask.scatter_(1, idx[:, None], True)
    y_topk = torch.where(mask, y, 0.0)
    return y_topk / (y_topk.sum(dim=1, keepdim=True) + 1e-10)


def get_weights_and_indices(logits: torch.Tensor, k: int):
    """Compact form: ([N, k] f32 weights, [N, k] int64 indices), ordered by
    ascending codebook index; the weights are a softmax over the selected
    logits (selection by raw logits, as the reference's softmax is monotone).

    The JAX version returns float indices; the port keeps them integer."""
    idx = torch.stack(_topk_columns(logits, k), dim=1)
    idx, _ = torch.sort(idx, dim=1)
    weights = torch.softmax(torch.gather(logits, 1, idx), dim=1)
    return weights.float(), idx
