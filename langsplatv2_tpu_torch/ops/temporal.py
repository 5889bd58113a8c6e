"""Temporal-coherence serving: reuse the tile binning across nearby poses
(port of langsplatv2_tpu/ops/temporal.py).

The interactive viewer renders a smooth camera path, so consecutive
requests differ by a few pixels of motion. A "bin frame" runs the
budget-capped binning (`rasterize.capped_binning`) at one pose and freezes
its dense [T, cap] layout: every window slot's fast16 row and its
pose-independent state (mean, world covariance, opacity) are gathered once,
in entry order. A "steady frame" at a nearby pose re-projects only the
cached entries (the same closed-form EWA, `project_gaussians` with
`cov3d_precomp`), rewrites the pose words of their rows (xy, conic,
opacity) and blends them with K2's fast16 mode on per-entry rows (g = slot
id, tile t's window at t*cap, kept frozen), or with its fused query mode
(K2q) when given phi and gram. It runs no preprocess, expansion, sort or
budget.

Approximation contract (as in JAX): the set and depth order of each tile's
entries are frozen at the bin pose; alpha uses the current pose's conic.
Entries that fall behind the near plane (depth <= 0.2) get opacity 0; their
conic or xy may be non-finite, and K2 skips a pair whose power is NaN, as
its plain version does. At the bin pose a steady frame equals a fresh
capped render with `cov3d_precomp`.

The cache holds T*cap entries of a 64-byte row and 40 bytes of state
(38 MB at 986x728 and 109 MB at 1920x1080 at cap 128); JAX pads the state
to 64 bytes for its gather.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from . import blend, projection
from .rasterize import (RasterizeSettings, check_slice, fast16_binned,
                        to_f32)


class BinCache(NamedTuple):
    """A frozen binning and its per-entry state, slot e of tile t at
    t * cap + e."""

    rows: torch.Tensor            # [T*cap, 16] int32 fast16 rows, bin pose
    geo: torch.Tensor             # [T*cap, 10] f32 mean3 | cov3d(6) | opacity
    kept: torch.Tensor            # [T] int32 per-tile blend counts (<= cap)
    total_entries: torch.Tensor   # [] int32 bin-frame expansion total
    live_total: torch.Tensor      # [] int32 kept total
    max_tile_count: torch.Tensor  # [] int32 saturation bound (> cap: full)


def build_cov3d(scales, rotations, scale_modifier: float = 1.0):
    """World covariance 6-vector (xx, xy, xz, yy, yz, zz) of R S S^T R^T
    from activated scales [N, 3] and quaternions [N, 4], in JAX's op
    order."""
    qn = rotations / torch.linalg.norm(rotations, dim=-1, keepdim=True)
    r, x, y, z = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
    R = [
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ]
    s2 = torch.square(scale_modifier * scales)

    def sig(i, j):
        return (s2[:, 0] * R[3 * i] * R[3 * j]
                + s2[:, 1] * R[3 * i + 1] * R[3 * j + 1]
                + s2[:, 2] * R[3 * i + 2] * R[3 * j + 2])

    return torch.stack([sig(0, 0), sig(0, 1), sig(0, 2), sig(1, 1),
                        sig(1, 2), sig(2, 2)], dim=1)


def _check(settings: RasterizeSettings) -> None:
    check_slice(settings)
    if not (settings.tile_budget > 0.0 and settings.precision == "bf16"):
        raise ValueError("temporal reuse rides the budget-capped fast16 "
                         "serving mode (tile_budget > 0, precision='bf16')")


def quick_bin_cache(settings: RasterizeSettings, means3d, opacities,
                    viewmatrix, projmatrix, campos, scales=None,
                    rotations=None, shs=None, colors_precomp=None,
                    quick_weights=None, quick_indices=None, *,
                    device=None) -> BinCache:
    """Run the capped binning at this pose and freeze it. (The JAX function
    also returns the bin pose's rows, which are `cache.rows` here.)"""
    _check(settings)
    dev = resolve_device(device)
    b = fast16_binned(settings, means3d, opacities, viewmatrix, projmatrix,
                      campos, scales, rotations, None, shs, colors_precomp,
                      quick_weights, quick_indices, dev=dev)
    with torch.no_grad():
        g = b.g.long()
        cov3d = build_cov3d(to_f32(scales, dev), to_f32(rotations, dev),
                            settings.scale_modifier)
        geo = torch.cat([to_f32(means3d, dev), cov3d, b.op[:, None]],
                        dim=1)[g]
        return BinCache(rows=b.rows[g], geo=geo, kept=b.count,
                        total_entries=b.total, live_total=b.live_total,
                        max_tile_count=b.max_tile_count)


def steady_entry_geom(settings: RasterizeSettings, cache: BinCache,
                      viewmatrix, projmatrix) -> torch.Tensor:
    """The cached rows with their pose words rebuilt at this pose: the
    EWA of `project_gaussians` on the cached means and covariances, and
    opacity 0 for entries behind the near plane. [T*cap, 16] int32."""
    dev = cache.geo.device
    xy, depth, conic, _radius, _, _ = projection.project_gaussians(
        cache.geo[:, 0:3], None, None,
        torch.as_tensor(viewmatrix, dtype=torch.float32, device=dev),
        torch.as_tensor(projmatrix, dtype=torch.float32, device=dev),
        settings.tanfovx, settings.tanfovy, settings.image_width,
        settings.image_height, settings.scale_modifier,
        cov3d_precomp=cache.geo[:, 3:9])
    op_live = torch.where(depth > 0.2, cache.geo[:, 9], 0.0)
    return torch.cat([blend.fast16_pose_words(xy, conic, op_live),
                      cache.rows[:, 4:]], dim=1)


def rasterize_quick_steady(settings: RasterizeSettings, cache: BinCache,
                           viewmatrix, projmatrix, bg,
                           quick_channels: int = 192, topk: int = 12,
                           phi=None, gram=None):
    """One steady frame against a frozen binning, on the cache's device.
    Without phi/gram: (rgb [T, 256, 3], feat [T, 256, C] (bf16 with
    feat_bf16), final_T [T, 256]) from K2's fast16 mode. With phi [L, K,
    PQ] and gram [L, K, K]: (rgb, raw [T, 256, L*PQ], nrm2 [T, 256, L],
    final_T) from K2q."""
    _check(settings)
    dev = cache.rows.device
    num_tiles = settings.grid_x * settings.grid_y
    cap = settings.tile_budget_cap
    with torch.no_grad():
        rows = steady_entry_geom(settings, cache, viewmatrix, projmatrix)
        g = torch.arange(num_tiles * cap, dtype=torch.int32, device=dev)
        starts = g[::cap].contiguous()
        bg = torch.as_tensor(bg, dtype=torch.float32, device=dev).contiguous()
        if phi is not None:
            return blend.blend_tiles_query(
                g, starts, cache.kept, rows, bg, settings.grid_x,
                settings.grid_y, topk,
                torch.as_tensor(phi, dtype=torch.float32, device=dev),
                torch.as_tensor(gram, dtype=torch.float32, device=dev),
                cells_bf16=settings.bf16_cells)
        return blend.blend_tiles_fast16(
            g, starts, cache.kept, rows, bg, settings.grid_x, settings.grid_y,
            topk, quick_channels, settings.feat_bf16,
            cells_bf16=settings.bf16_cells)


def motion_px(c2w0, c2w1, image_width: int, fovx: float,
              z_ref: float = 2.0) -> float:
    """Conservative image motion in pixels between two camera-to-world
    poses (host numpy): rotation angle * focal, plus |dt| / z_ref * focal
    with z_ref the nearest relevant scene depth."""
    f = 0.5 * image_width / math.tan(fovx / 2)
    r0 = np.asarray(c2w0)[:3, :3]
    r1 = np.asarray(c2w1)[:3, :3]
    dt = float(np.linalg.norm(np.asarray(c2w1)[:3, 3]
                              - np.asarray(c2w0)[:3, 3]))
    cos = (float(np.trace(r0.T @ r1)) - 1.0) / 2.0
    theta = float(np.arccos(np.clip(cos, -1.0, 1.0)))
    return f * (theta + dt / z_ref)
