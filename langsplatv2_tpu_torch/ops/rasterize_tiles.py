"""Tile layout -> image (port of langsplatv2_tpu/ops/rasterize_tiles.py:139-144).

The XLA tile blend of that module is the differentiable reference
rasterizer, a later slice."""
from __future__ import annotations

from .projection import BLOCK


def tiles_to_image(tiles, grid_x: int, grid_y: int, height: int, width: int):
    """[num_tiles, 256, C] row-major tiles -> [C, H, W] image (cropped)."""
    C = tiles.shape[-1]
    img = tiles.reshape(grid_y, grid_x, BLOCK, BLOCK, C)
    img = img.permute(4, 0, 2, 1, 3).reshape(C, grid_y * BLOCK, grid_x * BLOCK)
    return img[:, :height, :width]
