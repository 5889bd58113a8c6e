"""Tile binning: entry expansion (kernel K1), sort keys, tile ranges
(port of langsplatv2_tpu/ops/pallas_binning.py:354-630).

`expand_entries` replaces `expand_entries_pallas` (the TPU kernel
`_expand_kernel`). On a CUDA tensor it launches csrc/expand.cu; on a CPU
tensor it runs `expand_entries_plain`, which the GPU checks also use as
the oracle. The kernel is bound by bytes on the card (each Gaussian's
state read once, 12 B written an entry); csrc/expand.cu says how its
design meets that. `sort_entries` replaces `pack_sort_keys` +
`sorted_binning_from_keys`: those were `lax.sort`, not Pallas, so the
library sort is the port's sort too.
"""
from __future__ import annotations

import numpy as np
import torch

from . import kernels
from .projection import BLOCK, ProjectedGaussians


def _cull_mask(tile_x, tile_y, cx, cy, conic_a, conic_b, conic_c, op,
               inv_cull_alpha: float):
    """Exact conic-vs-tile cull: keep an entry iff the Gaussian's maximum
    alpha over the tile's pixel box reaches cull_alpha. Op for op in the
    order of the Pallas kernel (pallas_binning.py:292-322)."""
    ca = torch.clamp(conic_a, min=1e-12)
    cb = conic_b
    cc = torch.clamp(conic_c, min=1e-12)

    def q(u, v):
        return ca * u * u + 2.0 * cb * u * v + cc * v * v

    def edge_u(ufix, ly, hy):
        return q(ufix, torch.clamp(-cb * ufix / cc, min=ly, max=hy))

    def edge_v(vfix, lx, hx):
        return q(torch.clamp(-cb * vfix / ca, min=lx, max=hx), vfix)

    lx = tile_x.float() * float(BLOCK) - cx
    ly = tile_y.float() * float(BLOCK) - cy
    hx = lx + float(BLOCK - 1)
    hy = ly + float(BLOCK - 1)
    inside = (lx <= 0.0) & (0.0 <= hx) & (ly <= 0.0) & (0.0 <= hy)
    q_min = torch.minimum(
        torch.minimum(edge_u(lx, ly, hy), edge_u(hx, ly, hy)),
        torch.minimum(edge_v(ly, lx, hx), edge_v(hy, lx, hx)))
    q_min = torch.where(inside, 0.0, q_min)
    thresh = 2.0 * torch.log(torch.clamp(op, min=1e-12) * inv_cull_alpha) + 1e-4
    return q_min <= thresh


def expand_entries_plain(proj: ProjectedGaussians, opacities, offsets,
                         grid_x: int, grid_y: int, max_entries: int,
                         exact_cull: bool, inv_cull_alpha: float):
    """repeat_interleave expansion + the vectorized cull; same outputs as
    the kernel."""
    dev = proj.xy.device
    sentinel = grid_x * grid_y
    tiles = proj.tiles_touched.long()
    n_live = min(int(tiles.sum()), max_entries)
    gid = torch.repeat_interleave(
        torch.arange(tiles.shape[0], device=dev), tiles)[:n_live]
    slot = torch.arange(n_live, device=dev) - offsets[gid]
    rect_w = torch.clamp(proj.rect_max[gid, 0] - proj.rect_min[gid, 0], min=1)
    ty = torch.div(slot, rect_w, rounding_mode="floor")
    tile_x = proj.rect_min[gid, 0] + (slot - ty * rect_w)
    tile_y = proj.rect_min[gid, 1] + ty
    owned = torch.ones(n_live, dtype=torch.bool, device=dev)
    if exact_cull:
        owned = _cull_mask(tile_x, tile_y, proj.xy[gid, 0], proj.xy[gid, 1],
                           proj.conic[gid, 0], proj.conic[gid, 1],
                           proj.conic[gid, 2], opacities[gid], inv_cull_alpha)
    tile = torch.full((max_entries,), sentinel, dtype=torch.int32, device=dev)
    depth = torch.zeros(max_entries, dtype=torch.float32, device=dev)
    gauss = torch.zeros(max_entries, dtype=torch.int32, device=dev)
    tile[:n_live] = torch.where(owned, tile_y * grid_x + tile_x, sentinel).int()
    depth[:n_live] = torch.where(owned, proj.depth[gid], 0.0)
    gauss[:n_live] = torch.where(owned, gid, 0).int()
    return tile, depth, gauss


def expand_entries(proj: ProjectedGaussians, opacities: torch.Tensor,
                   grid_x: int, grid_y: int, max_entries: int, *,
                   exact_cull: bool = True,
                   cull_alpha: float = 1.0 / 255.0):
    """Per-entry (tile [E] i32 — sentinel grid_x*grid_y when dead, depth
    [E] f32, gauss [E] i32) at gaussian-major offsets, E = max_entries,
    plus total [] i32 = min(sum(tiles_touched), max_entries)."""
    dev = proj.xy.device
    n = proj.xy.shape[0]
    tiles = proj.tiles_touched
    offsets = torch.cumsum(tiles, 0, dtype=torch.int64) - tiles
    total = torch.clamp(tiles.sum(dtype=torch.int64), max=max_entries).int()
    # JAX multiplies by a Python float cast to f32: keep that constant.
    inv_cull_alpha = float(np.float32(1.0 / cull_alpha))
    if dev.type == "cpu":
        return (*expand_entries_plain(proj, opacities, offsets, grid_x,
                                      grid_y, max_entries, exact_cull,
                                      inv_cull_alpha), total)
    if dev.type != "cuda":
        raise ValueError(f"expand_entries: unsupported device {dev}")
    for name, t, dtype, shape in (
            ("xy", proj.xy, torch.float32, (n, 2)),
            ("depth", proj.depth, torch.float32, (n,)),
            ("conic", proj.conic, torch.float32, (n, 3)),
            ("opacities", opacities, torch.float32, (n,)),
            ("rect_min", proj.rect_min, torch.int32, (n, 2)),
            ("rect_max", proj.rect_max, torch.int32, (n, 2)),
            ("tiles_touched", tiles, torch.int32, (n,))):
        kernels.check_tensor(t, name, dtype, shape, dev)
    sentinel = grid_x * grid_y
    tile = torch.full((max_entries,), sentinel, dtype=torch.int32, device=dev)
    depth = torch.zeros(max_entries, dtype=torch.float32, device=dev)
    gauss = torch.zeros(max_entries, dtype=torch.int32, device=dev)
    P = kernels.ptr
    kernels.launch(
        "lsv2_expand_entries", P(proj.xy), P(proj.depth), P(proj.conic),
        P(opacities), P(proj.rect_min), P(proj.rect_max), P(tiles),
        P(offsets), n, grid_x, max_entries, sentinel, int(exact_cull),
        inv_cull_alpha, P(tile), P(depth), P(gauss), kernels.stream(tile))
    expand_entries.launches += 1
    return tile, depth, gauss, total


expand_entries.launches = 0


def sort_entries(tile, depth, gauss, num_tiles: int):
    """Stable sort of the gaussian-major entries by the int64 key
    tile << 31 | depth bits: the (tile, depth, gauss id) order of the JAX
    packed-key sort, dead entries (sentinel tile) last. Returns
    (g_sorted [E] i32, tile_start [T] i32, tile_count [T] i32)."""
    depth_bits = depth.view(torch.int32).long() & 0x7FFFFFFF
    key = (tile.long() << 31) | depth_bits
    key_sorted, perm = torch.sort(key, stable=True)
    g_sorted = gauss[perm]
    tile_sorted = (key_sorted >> 31).int()
    bounds = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, dtype=torch.int32,
                                  device=tile.device))
    return (g_sorted, bounds[:-1].int(),
            (bounds[1:] - bounds[:-1]).int())
