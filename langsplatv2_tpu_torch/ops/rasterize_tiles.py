"""The XLA route's tile blend and the tile layout -> image step (port of
langsplatv2_tpu/ops/rasterize_tiles.py).

`blend_tiles` is JAX's differentiable tile blend, written in plain torch
under autograd: for each tile the weights

    W[p, j] = alpha_j(p) * T_j(p),   T_j(p) = prod_{i<j} (1 - alpha_i(p))

over its first tile_cap depth-sorted entries, with JAX's alpha skip and
termination masks, then W @ [colour | features] a tile. Tiles go in
batches of tile_batch, as `lax.map` runs them, with sentinel-padded
batches; the transmittance is the exclusive cumprod of 1 - alpha and the
final T exp(sum(log1p(-alpha_included))), step by step as in JAX. The
gathers' backward is torch's accumulating index_put (index_add_), so the
sums on the card run in another order than JAX's: compare with allclose.

This blend is XLA code in the JAX package, not a Pallas kernel, so it has
no hand kernel. A batch only reads as many slots as its fullest tile holds
(at most tile_cap): the slots past a tile's count are masked to zero
weight in JAX, so the outputs and gradients are the same. The products run
as `torch.bmm` in f32; on the card they stay true f32 only with TF32 off
(`torch.backends.cuda.matmul.allow_tf32`, torch's default), as JAX's
Precision.HIGHEST einsums do.
"""
from __future__ import annotations

import torch

from .binning import BinnedTiles
from .projection import BLOCK

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

P = BLOCK * BLOCK  # pixels per tile


def _tile_pixel_coords(tile_ids: torch.Tensor, grid_x: int):
    """Pixel coordinates of each tile's P pixels, row-major: (px [TB, P],
    py [TB, P]) float32."""
    dev = tile_ids.device
    tx = (tile_ids % grid_x).float()
    ty = torch.div(tile_ids, grid_x, rounding_mode="floor").float()
    col = torch.arange(BLOCK, dtype=torch.float32, device=dev).repeat(BLOCK)
    row = torch.arange(BLOCK, dtype=torch.float32,
                       device=dev).repeat_interleave(BLOCK)
    px = tx[:, None] * BLOCK + col[None, :]
    py = ty[:, None] * BLOCK + row[None, :]
    return px, py


def blend_tiles(proj_xy, proj_conic, opacities, colors, features,
                binned: BinnedTiles, grid_x: int, grid_y: int, bg,
                tile_cap: int, tile_batch: int, tile_ids=None):
    """Blend all grid tiles, or the subset `tile_ids` [T_local]. proj_xy
    [N, 2], proj_conic [N, 3], opacities [N] (activated), colors [N, 3],
    features [N, D] or None, bg [3]. Returns (rgb [T, P, 3], feat [T, P,
    D] | None, final_T [T, P]), differentiable in the per-Gaussian
    inputs."""
    dev = proj_xy.device
    num_tiles = grid_x * grid_y
    if tile_ids is None:
        tile_ids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    n_local = tile_ids.shape[0]
    num_batches = -(-n_local // tile_batch)
    padded = num_batches * tile_batch
    ids_all = torch.cat([tile_ids.to(torch.int32), torch.full(
        (padded - n_local,), num_tiles, dtype=torch.int32, device=dev)]
    ).reshape(num_batches, tile_batch)
    max_entries = binned.gauss_id.shape[0]
    feat_dim = features.shape[1] if features is not None else 0
    # One gather a batch: [x, y, conic a/b/c, opacity, r, g, b, features].
    state = torch.cat([proj_xy, proj_conic, opacities[:, None], colors]
                      + ([features] if features is not None else []), 1)
    real_all = ids_all < num_tiles
    safe_all = torch.clamp(ids_all, max=num_tiles - 1).long()
    count_all = torch.where(real_all, binned.tile_count[safe_all], 0)
    caps = torch.clamp(count_all.amax(1), min=1, max=tile_cap).tolist()

    rgbs, feats, final_ts = [], [], []
    for b in range(num_batches):
        cap = caps[b]
        start = binned.tile_start[safe_all[b]].long()              # [TB]
        count = count_all[b]
        slots = torch.arange(cap, device=dev)
        eidx = torch.clamp(start[:, None] + slots[None, :],
                           max=max_entries - 1)
        in_range = slots[None, :] < torch.clamp(count, max=tile_cap)[:, None]
        g = binned.gauss_id[eidx].long()                          # [TB, CAP]
        st = state[g]                                        # [TB, CAP, F]

        px, py = _tile_pixel_coords(safe_all[b], grid_x)            # [TB, P]
        dx = st[:, None, :, 0] - px[:, :, None]                # [TB, P, CAP]
        dy = st[:, None, :, 1] - py[:, :, None]
        ca = st[:, None, :, 2]
        cb = st[:, None, :, 3]
        cc = st[:, None, :, 4]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(st[:, None, :, 5] * torch.exp(power),
                            max=ALPHA_MAX)
        valid = in_range[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        alpha = torch.where(valid, alpha, 0.0)

        one_minus = 1.0 - alpha
        # Exclusive cumulative product along the depth-sorted entries.
        T = torch.cumprod(torch.cat([torch.ones_like(one_minus[..., :1]),
                                     one_minus[..., :-1]], -1), -1)
        include = valid & (T * one_minus >= T_EPS)
        w = torch.where(include, alpha * T, 0.0)                # [TB, P, CAP]

        out = torch.bmm(w, st[..., 6:])                      # [TB, P, 3 + D]
        alpha_incl = torch.where(include, alpha, 0.0)
        final_t = torch.exp(torch.sum(torch.log1p(-alpha_incl), -1))
        rgbs.append(out[..., :3] + final_t[..., None] * bg[None, None, :])
        feats.append(out[..., 3:])
        final_ts.append(final_t)

    rgb = torch.cat(rgbs)[:n_local]
    feat = torch.cat(feats)[:n_local] if feat_dim else None
    final_t = torch.cat(final_ts)[:n_local]
    return rgb, feat, final_t


def tiles_to_image(tiles, grid_x: int, grid_y: int, height: int, width: int):
    """[num_tiles, 256, C] row-major tiles -> [C, H, W] image (cropped)."""
    C = tiles.shape[-1]
    img = tiles.reshape(grid_y, grid_x, BLOCK, BLOCK, C)
    img = img.permute(4, 0, 2, 1, 3).reshape(C, grid_y * BLOCK, grid_x * BLOCK)
    return img[:, :height, :width]
