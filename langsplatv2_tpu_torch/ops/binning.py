"""Tile binning of the differentiable XLA route (port of
langsplatv2_tpu/ops/binning.py): `BinnedTiles` and `bin_gaussians`.

The JAX function expands every (Gaussian, tile) pair of the tile rects with
no exact cull, sorts the entries by (tile, depth) with ties in Gaussian
order, and finds each tile's segment. On a TPU it runs the Pallas expansion
with exact_cull=False (`binning.py:47-66`), elsewhere a searchsorted
expansion (`:68-108`); both give the same entries. Here a CUDA tensor
launches K1 (`ops/expand.py`, csrc/expand.cu) in its no-cull mode and the
port's key sort; a CPU tensor runs K1's plain version in the same mode.

`total_entries` is the unclamped sum of tiles_touched (`binning.py:72`):
above max_entries it shows the overflow, and the entries past the budget
are the gaussian-major tail that was cut. Dead entries (at or past the
live total) carry the last Gaussian's id, as the searchsorted expansion
leaves them. Nothing here is differentiable, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import expand
from .projection import ProjectedGaussians


class BinnedTiles(NamedTuple):
    gauss_id: torch.Tensor       # [max_entries] int32 Gaussian an entry
    entry_valid: torch.Tensor    # [max_entries] bool
    tile_start: torch.Tensor     # [num_tiles] int32 first entry of each tile
    tile_count: torch.Tensor     # [num_tiles] int32 entries of each tile
    total_entries: torch.Tensor  # [] int32 sum of tiles_touched (unclamped)


@torch.no_grad()
def bin_gaussians(proj: ProjectedGaussians, grid_x: int, grid_y: int,
                  max_entries: int, opacities=None) -> BinnedTiles:
    """The (tile, depth)-sorted entries of `proj`'s tile rects, no cull.
    `opacities` [N] is what K1 reads beside the rects; without the cull it
    decides nothing (default: ones)."""
    num_tiles = grid_x * grid_y
    n = proj.xy.shape[0]
    tiles = proj.tiles_touched
    if opacities is None:
        opacities = torch.ones(n, device=proj.xy.device)
    tile, depth, gauss, _ = expand.expand_entries(
        proj, opacities.detach().contiguous(), grid_x, grid_y, max_entries,
        exact_cull=False)
    g_sorted, tile_start, tile_count = expand.sort_entries(
        tile, depth, gauss, num_tiles)
    total = tiles.sum(dtype=torch.int64).to(torch.int32)
    live = min(int(total), max_entries)
    valid = torch.arange(max_entries, device=tile.device) < live
    g_sorted = torch.where(valid, g_sorted, max(n - 1, 0))
    return BinnedTiles(gauss_id=g_sorted, entry_valid=valid,
                       tile_start=tile_start, tile_count=tile_count,
                       total_entries=total)
