"""Merged 3-level quick model (port of langsplatv2_tpu/eval/lerf.py:64-84).

The LERF benchmark driver itself belongs to the eval slice.
"""
from __future__ import annotations

import torch

from ..models.gaussians import GaussianModel


def merge_level_models(models: list[GaussianModel],
                       topk: int = 4) -> GaussianModel:
    """Per-level models -> one quick-render model: weights/indices
    [N, levels*topk] with indices offset by level * (codebook rows of a
    model), codebooks stacked [levels, K, 512]."""
    ws, idxs, books = [], [], []
    for lvl, m in enumerate(models):
        w, idx = m.get_weights_and_indices(topk)
        ws.append(w)
        idxs.append(idx + lvl * m.codebooks.shape[1] * m.codebooks.shape[0])
        books.append(m.codebooks.detach())
    return models[0].replace(quick_weights=torch.cat(ws, dim=1),
                             quick_indices=torch.cat(idxs, dim=1),
                             codebooks=torch.cat(books, dim=0))
