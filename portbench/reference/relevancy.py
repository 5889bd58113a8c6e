"""LERF's relevancy from a merged quick model's coefficient map (the
paper's eval_lerf.py: decode each level's 64 coefficients through its
codebook, normalize, score against the phrases, then the softmax of
10 x [positive, negative] pairs, its positive share, least over the
negatives)."""
from __future__ import annotations

import torch

from .precision import matmul
from .render import tiles_to_image

ROWS = 1 << 16          # pixels a block


def relevancy(feat_tiles, codebooks, positives, negatives, grid: tuple,
              height: int, width: int, prec: str = "f32") -> torch.Tensor:
    """feat_tiles [T, 256, L*K], codebooks [L, K, D], unit phrases
    positives [P, D] and negatives [N, D] -> relevancy [L, P, H, W]."""
    L, K, _ = codebooks.shape
    n_pos = positives.shape[0]
    phrases = torch.cat([positives, negatives], 0)
    t = feat_tiles.shape[0]
    flat = feat_tiles.reshape(t * 256, L * K)
    out = torch.empty((t * 256, L * n_pos), device=feat_tiles.device)
    for s in range(0, flat.shape[0], ROWS):
        blk = flat[s:s + ROWS]
        for lvl in range(L):
            f = matmul(blk[:, lvl * K:(lvl + 1) * K], codebooks[lvl], prec)
            f = f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-10)
            sim = matmul(f, phrases.T, prec)                 # [q, P + N]
            pos, neg = sim[:, :n_pos], sim[:, n_pos:]
            pairs = torch.stack([pos[:, :, None].expand(-1, -1, neg.shape[1]),
                                 neg[:, None, :].expand(-1, n_pos, -1)], -1)
            share = torch.softmax(10.0 * pairs, dim=-1)[..., 0]
            out[s:s + ROWS, lvl * n_pos:(lvl + 1) * n_pos] = share.amin(-1)
    img = tiles_to_image(out.reshape(t, 256, L * n_pos), *grid, height, width)
    return img.reshape(L, n_pos, height, width)
