"""Rasterizer entry point, sort-binning path
(port of langsplatv2_tpu/ops/rasterize.py:168-277 and `_rasterize_pallas`,
sort branch, with `_sorted_quick_binning` and `_assemble`).

    preprocess -> expand (K1) -> key sort -> tile ranges
      [-> live_entries prefix clamp] -> blend (K2, "rgb" | "quick") -> assemble

`quick_train=True` (feature-phase training, :213-231) takes the same path
with the quick blend wrapped in `ops/train.py::QuickTrainBlend`, whose
backward (K4) gives d(quick_weights). RGB mode (:258-271) goes through
`ops/rgb_train.py::rasterize_rgb_vjp`: the blend with bg = 0 wrapped in
`RGBTrainBlend`, whose backward (K7) gives d(xy, conic, opacity, colour),
and the background composited outside it; the output equals the plain
blend's with the background inside, so serving and training share it.

Options that belong to later slices of the port raise NotImplementedError
naming the slice; none of them falls back to another path.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from . import blend, expand, projection, rasterize_tiles, rgb_train, train
from .projection import BLOCK


class RasterizeSettings(NamedTuple):
    """Static rasterization configuration (the JAX field names)."""

    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    sh_degree: int
    scale_modifier: float = 1.0
    max_entries: int = 2 ** 21        # expansion budget (overflow telemetry)
    tile_cap: int = 1024
    tile_batch: int = 16
    prefiltered: bool = False
    debug: bool = False
    impl: str = "auto"
    binning: str = "sort"
    precision: str = "f32"
    bf16_cells: bool = False
    feat_bf16: bool = True            # bf16 rows only (a later slice)
    assemble: bool = True             # False: feature map in [T, 256, C]
    live_entries: int = 0             # sorted live-prefix budget, 0 = off
    pair_capacity: int = 0
    tile_budget: float = 0.0
    tile_budget_cap: int = 128
    tile_budget_subdiv: int = 2
    cull_alpha: float = 1.0 / 255.0

    @property
    def grid_x(self) -> int:
        return -(-self.image_width // BLOCK)

    @property
    def grid_y(self) -> int:
        return -(-self.image_height // BLOCK)


class RasterizeOutput(NamedTuple):
    rgb: torch.Tensor                  # [3, H, W]
    feature_map: torch.Tensor | None   # [C, H, W], or [T, 256, C] unassembled
    radii: torch.Tensor                # [N] int32
    final_transmittance: torch.Tensor  # [H, W]
    max_tile_count: torch.Tensor       # [] int32
    total_entries: torch.Tensor        # [] int32, >= max_entries = overflow
    live_total: torch.Tensor | None = None   # [] entries surviving the cull


def _later(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} belongs to a later slice of the port: {slice_name} "
        "(ROADMAP.md, Queue 1)")


# Fields the sort path at f32 does not read, with the slice that will.
_LATER_FIELDS = {
    "tile_cap": "the differentiable reference rasterizer (item 4)",
    "tile_batch": "the differentiable reference rasterizer (item 4)",
    "bf16_cells": "bf16 serving rows (Queue 2, K2)",
    "feat_bf16": "bf16 serving rows (Queue 2, K2)",
    "pair_capacity": "distribution (item 12)",
    "tile_budget_cap": "capped and temporal serving (item 9)",
    "tile_budget_subdiv": "capped and temporal serving (item 9)",
}
# Fields that no path of either package reads.
_UNREAD_FIELDS = ("prefiltered", "debug")


def check_slice(settings: RasterizeSettings, *, cov3d_precomp=None,
                features=None) -> None:
    """Raise for every option outside the ported slices (the sort path,
    f32 rows, rgb and quick modes, quick training), and for a non-default
    value of a field this path would otherwise ignore."""
    defaults = RasterizeSettings._field_defaults
    for name, slice_name in _LATER_FIELDS.items():
        if getattr(settings, name) != defaults[name]:
            raise _later(f"{name}={getattr(settings, name)!r}", slice_name)
    for name in _UNREAD_FIELDS:
        if getattr(settings, name) != defaults[name]:
            raise ValueError(f"{name} is read by no rasterizer path; leave "
                             f"it at {defaults[name]!r}")
    if settings.tile_budget > 0.0:
        raise _later("tile_budget > 0", "capped and temporal serving (item 9)")
    if settings.binning == "cascade":
        raise _later('binning="cascade"', "the cascade binner, kernel K8")
    if settings.binning == "gauss":
        raise _later('binning="gauss"', "distribution (item 12)")
    if settings.binning != "sort":
        raise ValueError(f"unknown binning {settings.binning!r}")
    if settings.precision == "bf16":
        raise _later('precision="bf16"', "bf16 serving rows (Queue 2, K2)")
    if settings.precision != "f32":
        raise ValueError(f"unknown precision {settings.precision!r}")
    if settings.impl == "xla":
        raise _later('impl="xla"',
                     "the differentiable reference rasterizer (item 4)")
    if features is not None:
        raise _later("dense features",
                     "the dense training blend (Queue 2, K2 dense mode)")
    if cov3d_precomp is not None:
        raise _later("cov3d_precomp",
                     "the differentiable reference rasterizer (item 4)")


def mark_stage(stage_events, name: str) -> None:
    """Append (name, a CUDA event recorded now) when timing is asked for."""
    if stage_events is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        stage_events.append((name, ev))


def sorted_binning(settings: RasterizeSettings, proj, opacities,
                   stage_events=None):
    """expand -> sort -> tile ranges, with the live-prefix clamp. Returns
    (g_sorted, tile_start, tile_count, total, live_total)."""
    num_tiles = settings.grid_x * settings.grid_y
    tile, depth, gauss, total = expand.expand_entries(
        proj, opacities, settings.grid_x, settings.grid_y,
        settings.max_entries, exact_cull=True, cull_alpha=settings.cull_alpha)
    mark_stage(stage_events, "expand")
    g_sorted, tile_start, tile_count = expand.sort_entries(
        tile, depth, gauss, num_tiles)
    live_total = tile_count.sum(dtype=torch.int32)
    live = settings.live_entries
    if 0 < live < settings.max_entries:
        g_sorted = g_sorted[:live]
        tile_count = torch.clamp(
            torch.minimum(tile_count, live - tile_start), min=0).int()
    return g_sorted, tile_start, tile_count, total, live_total


def rasterize(settings: RasterizeSettings, means3d, opacities, viewmatrix,
              projmatrix, campos, bg, scales=None, rotations=None,
              cov3d_precomp=None, shs=None, colors_precomp=None,
              features=None, quick_weights=None, quick_indices=None,
              quick_channels: int = 192, quick_train: bool = False,
              means2d_dummy=None, *, device=None,
              stage_events: list | None = None) -> RasterizeOutput:
    """Quick mode when quick_weights/quick_indices [N, S] are given (the
    merged-model serving path), RGB only otherwise. With quick_train the
    feature map is differentiable in quick_weights (and in nothing else).
    In RGB mode the image and final transmittance are differentiable in
    means3d, scales, rotations, opacities, shs / colors_precomp and
    `means2d_dummy` [N, 2] (the densification statistics' carrier).

    `stage_events` (CUDA only): a list that gets (stage name, recorded
    torch.cuda.Event) after "start", "preprocess", "expand", "sort",
    "blend" and "assemble"; consecutive events time each stage."""
    check_slice(settings, cov3d_precomp=cov3d_precomp, features=features)
    if scales is None or rotations is None:
        raise ValueError("rasterize needs scales and rotations")
    dev = resolve_device(device)

    def f32(x):
        return None if x is None else torch.as_tensor(
            x, dtype=torch.float32, device=dev)

    H, W = settings.image_height, settings.image_width
    grid_x, grid_y = settings.grid_x, settings.grid_y
    opacities = f32(opacities)
    bg = f32(bg).contiguous()
    mark_stage(stage_events, "start")
    proj = projection.preprocess(
        f32(means3d), f32(scales), f32(rotations), f32(shs),
        f32(colors_precomp), f32(viewmatrix), f32(projmatrix), f32(campos),
        settings.tanfovx, settings.tanfovy, W, H, settings.sh_degree,
        settings.scale_modifier, opacities=opacities[:, 0].detach(),
        cull_alpha=settings.cull_alpha)
    mark_stage(stage_events, "preprocess")
    with torch.no_grad():   # binning is not differentiable
        g_sorted, tile_start, tile_count, total, live_total = sorted_binning(
            settings, projection.detach(proj), opacities[:, 0].detach(),
            stage_events)
    mark_stage(stage_events, "sort")
    if quick_weights is None:
        rgb, final_t = rgb_train.rasterize_rgb_vjp(
            settings, proj, opacities[:, 0], (g_sorted, tile_start,
                                              tile_count), bg,
            None if means2d_dummy is None else f32(means2d_dummy))
        mark_stage(stage_events, "blend")
        mark_stage(stage_events, "assemble")
        return RasterizeOutput(
            rgb=rgb, feature_map=None, radii=proj.radius,
            final_transmittance=final_t, max_tile_count=tile_count.max(),
            total_entries=total, live_total=live_total)
    if means2d_dummy is not None:
        raise ValueError("means2d_dummy is read in RGB mode only")
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, opacities[:, 0],
                                     proj.rgb)
    qw = f32(quick_weights).contiguous()
    qi = torch.as_tensor(quick_indices, device=dev).to(torch.int32).contiguous()
    if quick_train:
        rgb_t, feat_t, t_t = train.QuickTrainBlend.apply(
            qw, g_sorted, tile_start, tile_count, geom, bg, qi, grid_x,
            grid_y, quick_channels)
    else:
        rgb_t, feat_t, t_t = blend.blend_tiles(
            g_sorted, tile_start, tile_count, geom, bg, grid_x, grid_y, qw,
            qi, quick_channels)
    mark_stage(stage_events, "blend")
    rgb = rasterize_tiles.tiles_to_image(rgb_t, grid_x, grid_y, H, W)
    if settings.assemble:
        feat_t = rasterize_tiles.tiles_to_image(feat_t, grid_x, grid_y, H, W)
    final_t = rasterize_tiles.tiles_to_image(
        t_t[..., None], grid_x, grid_y, H, W)[0]
    mark_stage(stage_events, "assemble")
    return RasterizeOutput(
        rgb=rgb, feature_map=feat_t, radii=proj.radius,
        final_transmittance=final_t, max_tile_count=tile_count.max(),
        total_entries=total, live_total=live_total)
