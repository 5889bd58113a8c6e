"""Rasterizer entry point: the kernel routes and the XLA route
(port of langsplatv2_tpu/ops/rasterize.py:168-329 and `_rasterize_pallas`,
sort branch, with `_sorted_quick_binning`, `_capped_quick_binning`,
`_capped_kept_from_rows` and `_assemble`).

    preprocess -> expand (K1) -> key sort -> tile ranges
      [-> live_entries prefix clamp] -> blend (K2, "rgb" | "quick") -> assemble

`quick_train=True` (feature-phase training, :213-231) takes the same path
with the quick blend wrapped in `ops/train.py::QuickTrainBlend`, whose
backward (K4) gives d(quick_weights). RGB mode (:258-271) goes through
`ops/rgb_train.py::rasterize_rgb_vjp`: the blend with bg = 0 wrapped in
`RGBTrainBlend`, whose backward (K7) gives d(xy, conic, opacity, colour),
and the background composited outside it; the output equals the plain
blend's with the background inside, so serving and training share it.

precision="bf16" switches quick serving to the fast16 rows (K2's fast16
mode; with feat_bf16 the map comes out in bf16 and K3 reads it so).
tile_budget > 0 takes the budget-capped route where the JAX package does:
quick serving at precision="bf16" (:399-444) and quick training with a
top-k width of at most 4 (pallas_train.py:609-654). Each tile then blends
the depth prefix of its window of tile_budget_cap entries whose
transmittance bound stays above the budget (ops/budget.py); training's
backward is K5. Elsewhere, as in JAX, the budget fields are not read.

`rasterize_quick_query` (:590-653) is the serving frame with the Gram
query fused into the blend (K2's query mode, K2q): fast16 rows, exact or
capped binning, and per-prompt raw scores and per-level norms out instead
of the [T, 256, L*K] map. `cov3d_precomp` [N, 6] replaces scales and
rotations in the preprocess (the temporal steady frames' formulation).
The fast16 frames apply JAX's level bands (the blend wrappers take them
where `blend.level_banded` holds) and, with
bf16_cells (read only where precision="bf16", as in JAX), K2's bf16 cell
math.

Dense features (:244-257, `pallas_train.py::rasterize_dense_vjp`):
`features` [N, D] is blended by K2's dense mode inside
`ops/train.py::DenseTrainBlend`, whose backward (K4 + `index_add_`) gives
d(features) and nothing else (the feature-phase contract). Without
cov3d_precomp the binning is the VJP's (default cull, no live clamp);
with it, the forward-only branch of `_rasterize_pallas` (:454-460: the
settings' cull and live clamp). These are impl="pallas"'s: under "auto"
dense features take the XLA route, which differentiates the geometry
too.

binning="cascade" (:369-397) bins a quick frame that is not a quick_train
frame with K8 (`ops/cascade.py`) and blends its segments with K2's f32
mode, whatever the precision and the budget fields say, forward only;
total_entries counts the kept entries and folds the overflow flag in. An
RGB frame takes it only under impl="pallas".

The XLA route (`_rasterize_xla`, JAX :280-329) is JAX's differentiable
pipeline: the preprocess under autograd (the 3-sigma tile rects, no
opacity-aware rect), the `means2d_dummy` carrier in every mode, quick
pairs turned into dense channels, `ops/binning.py::bin_gaussians` (K1
without the exact cull, the key sort), `ops/rasterize_tiles.py::
blend_tiles` (plain torch under autograd, tile_cap entries a tile,
tile_batch tiles a batch) and the images. Every output is differentiable
in every per-Gaussian input. JAX turns the quick pairs into channels with
a one_hot einsum; here a scatter_add into [N, quick_channels] forms the
same sums without the [N, S, C] one-hot (9.2 GB at 1M x 12 x 192). It
returns max_tile_count = the largest tile count, JAX's unclamped
total_entries and live_total None, always assembles, and reads none of
the kernel routes' fields (precision, budgets, live_entries, cull_alpha).

impl="auto" routes as JAX's "auto" does on a TPU (JAX :213-242):

| input | route |
|---|---|
| quick serving (quick_weights, not quick_train) | kernel (K2, fast16, K8) |
| quick_train without cov3d_precomp | kernel (QuickTrainBlend, capped) |
| quick_train with cov3d_precomp (under every impl) | XLA |
| dense features | XLA |
| RGB on the sort binning without cov3d_precomp | kernel (K7) |
| RGB with cov3d_precomp, or on binning="cascade" | XLA |

impl="xla" takes the XLA route for every input; impl="pallas" the kernel
routes (quick_train with cov3d_precomp aside), dense features there by
K2's dense mode. binning="gauss" with `mesh=` (JAX :192-210) is the
Gaussian-sharded forward of parallel/gauss_sharded.py, each rank passing
its own rows, with the exchange's `dropped_entries`; pair_capacity is read
there only. No option falls back to another path.

Every route opens the same spans (tracing.py) at its matching points:
"preprocess", "binning" (expansion and sort, or K8, or bin_gaussians),
"blend" (the rows' packing and K2) and "assemble" (the tiles to images).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tracing
from ..device import resolve_device, to_f32
from . import (binning, blend, budget, cascade, expand, projection,
               rasterize_tiles, rgb_train, train)
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
    feat_bf16: bool = True            # fast16 rows: bf16 output tiles
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
    # [] int32, binning="gauss" only: entries a (source, destination) pair
    # of the exchange dropped past pair_capacity.
    dropped_entries: torch.Tensor | None = None


# Fields that no path of either package reads.
_UNREAD_FIELDS = ("prefiltered", "debug")


def check_slice(settings: RasterizeSettings, gauss: bool = False) -> None:
    """Raise for an unknown binning, precision or impl, and for a
    non-default value of a field no path reads. binning="gauss" renders
    through `rasterize(..., mesh=...)` only (`gauss`: the caller is that
    route). Fields a route reads (tile_cap, tile_batch, the budget and
    fast16 fields, pair_capacity) are, as in JAX, not read on the other
    routes."""
    defaults = RasterizeSettings._field_defaults
    for name in _UNREAD_FIELDS:
        if getattr(settings, name) != defaults[name]:
            raise ValueError(f"{name} is read by no rasterizer path; leave "
                             f"it at {defaults[name]!r}")
    if settings.binning == "gauss" and not gauss:
        raise ValueError('binning="gauss" renders only through rasterize('
                         '..., mesh=...)')
    if settings.binning not in ("sort", "cascade", "gauss"):
        raise ValueError(f"unknown binning {settings.binning!r}")
    if settings.precision not in ("f32", "bf16"):
        raise ValueError(f"unknown precision {settings.precision!r}")
    if settings.impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown impl {settings.impl!r}")


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


def capped_binning(settings: RasterizeSettings, proj, opacities,
                   rounded: bool, stage_events=None):
    """expand -> sort -> the dense [T, tile_budget_cap] windows and their
    budget counts, the bound read from the slots' xy, conic and opacity
    (bf16-rounded conic and opacity when `rounded`, as the fast16 rows
    carry them). Returns (g_win [T*cap], window starts t*cap, kept [T]
    clamped to tile_cap, sat_bound [T], total)."""
    cap = settings.tile_budget_cap
    if cap % 128:
        raise ValueError(f"tile_budget_cap must be a multiple of 128, not "
                         f"{cap}")
    num_tiles = settings.grid_x * settings.grid_y
    tile, depth, gauss, total = expand.expand_entries(
        proj, opacities, settings.grid_x, settings.grid_y,
        settings.max_entries, exact_cull=True, cull_alpha=settings.cull_alpha)
    mark_stage(stage_events, "expand")
    g_sorted, tile_start, tile_count = expand.sort_entries(
        tile, depth, gauss, num_tiles)
    mark_stage(stage_events, "sort")
    g_win = budget.slice_windows(g_sorted, tile_start, cap).reshape(-1)
    conic, op = proj.conic, opacities
    if rounded:
        conic, op = (x.to(torch.bfloat16).float() for x in (conic, op))
    g = g_win.long()
    kept, sat_bound = budget.budget_from_rows(
        proj.xy[g], conic[g], op[g], tile_count, settings.grid_x, cap,
        settings.tile_budget_subdiv, settings.tile_budget)
    kept = torch.clamp(kept, max=settings.tile_cap)
    starts = torch.arange(num_tiles, dtype=torch.int32,
                          device=g_win.device) * cap
    return g_win, starts, kept, sat_bound, total


def _per_gaussian(dev, means3d, scales, rotations, shs, colors_precomp):
    """The preprocess's per-Gaussian inputs as float32 on `dev` (`shs` a
    tensor or the (dc, rest) pair); the camera goes to it as given."""
    return (to_f32(means3d, dev), to_f32(scales, dev),
            to_f32(rotations, dev), projection.shs_f32(shs, dev),
            to_f32(colors_precomp, dev))


def _preprocess_frozen(settings, means3d, opacities, viewmatrix,
                       projmatrix, campos, scales, rotations, cov3d_precomp,
                       shs, colors_precomp, dev, stage_events):
    """The preprocess outside autograd and the [N] opacities, for the routes
    that differentiate no geometry (fast16, dense, cascade); stage events
    "start" and "preprocess"."""
    with torch.no_grad(), tracing.span("preprocess"):
        op = opacities[:, 0].detach().contiguous()
        mark_stage(stage_events, "start")
        proj = projection.preprocess(
            *_per_gaussian(dev, means3d, scales, rotations, shs,
                           colors_precomp), viewmatrix, projmatrix, campos,
            settings.tanfovx, settings.tanfovy, settings.image_width,
            settings.image_height, settings.sh_degree,
            settings.scale_modifier, opacities=op,
            cull_alpha=settings.cull_alpha,
            cov3d_precomp=to_f32(cov3d_precomp, dev))
        mark_stage(stage_events, "preprocess")
        return projection.detach(proj), op


class Fast16Binned(NamedTuple):
    """A fast16 frame up to its blend."""

    proj: projection.ProjectedGaussians
    op: torch.Tensor               # [N] f32 opacities
    rows: torch.Tensor             # [N, 16] int32 fast16 rows
    g: torch.Tensor                # [E] int32 Gaussian ids in blend order
    start: torch.Tensor            # [T] int32 tile segment starts
    count: torch.Tensor            # [T] int32 tile blend counts
    max_tile_count: torch.Tensor   # [] int32 (capped: saturation bound)
    total: torch.Tensor            # [] int32 expansion total
    live_total: torch.Tensor       # [] int32 (capped: the kept total)


def fast16_binned(settings: RasterizeSettings, means3d, opacities,
                  viewmatrix, projmatrix, campos, scales=None, rotations=None,
                  cov3d_precomp=None, shs=None, colors_precomp=None,
                  quick_weights=None, quick_indices=None, *, dev,
                  stage_events=None) -> Fast16Binned:
    """The fast16 serving frame's setup, without gradients: the
    preprocess, then the capped windows when tile_budget > 0 (the budget
    read from the rows' bf16-rounded conic and opacity, kept clamped to
    tile_cap) or the sorted binning with the live-prefix clamp, then the
    fast16 rows. Shared by `rasterize`'s fast16 route,
    `rasterize_quick_query` and `temporal.quick_bin_cache`; stage events
    "start" to "budget" / "sort" as `rasterize` documents them."""
    capped = settings.tile_budget > 0.0
    proj, op = _preprocess_frozen(
        settings, means3d, to_f32(opacities, dev), viewmatrix, projmatrix,
        campos, scales, rotations, cov3d_precomp, shs, colors_precomp, dev,
        stage_events)
    with torch.no_grad():
        with tracing.span("binning"):
            if capped:
                g, start, count, sat_bound, total = capped_binning(
                    settings, proj, op, True, stage_events)
                max_tile_count = sat_bound.max()
                live_total = count.sum(dtype=torch.int32)
            else:
                g, start, count, total, live_total = sorted_binning(
                    settings, proj, op, stage_events)
                max_tile_count = count.max()
        mark_stage(stage_events, "budget" if capped else "sort")
        with tracing.span("blend"):
            qi = torch.as_tensor(quick_indices, device=dev).to(torch.int32)
            rows = blend.pack_fast16_rows(
                proj.xy, proj.conic, op, proj.rgb,
                to_f32(quick_weights, dev).contiguous(), qi.contiguous())
    return Fast16Binned(proj, op, rows, g, start, count, max_tile_count,
                        total, live_total)


def rasterize(settings: RasterizeSettings, means3d, opacities, viewmatrix,
              projmatrix, campos, bg, scales=None, rotations=None,
              cov3d_precomp=None, shs=None, colors_precomp=None,
              features=None, quick_weights=None, quick_indices=None,
              quick_channels: int = 192, quick_train: bool = False,
              means2d_dummy=None, *, device=None,
              stage_events: list | None = None,
              mesh=None) -> RasterizeOutput:
    """Quick mode when quick_weights/quick_indices [N, S] are given (the
    merged-model serving path), dense mode when `features` [N, D] is (the
    feature map differentiable in features only), RGB only otherwise. With
    quick_train the feature map is differentiable in quick_weights (and in
    nothing else). In RGB mode on the sort binning the image and final
    transmittance are differentiable in means3d, scales, rotations,
    opacities, shs / colors_precomp and `means2d_dummy` [N, 2] (the
    densification statistics' carrier). On the XLA route (`xla_route`:
    impl="xla", and the inputs the module docstring's table sends there)
    every output is differentiable in every per-Gaussian input, the
    carrier included, in every mode.

    On the capped routes max_tile_count is the tiles' saturation bound
    (> tile_budget_cap: a window was full) and live_total the kept total.

    `stage_events` (CUDA only): a list that gets (stage name, recorded
    torch.cuda.Event) after "start", "preprocess", "expand", "sort",
    ("budget": the windows and their counts, capped routes), "blend" and
    "assemble" (the XLA route: "sort" is bin_gaussians, with no "expand");
    consecutive events time each stage."""
    quick = quick_weights is not None
    dense = features is not None
    check_slice(settings, gauss=True)
    if settings.binning == "gauss":
        return _rasterize_gauss(settings, mesh, means3d, opacities,
                                viewmatrix, projmatrix, campos, bg, scales,
                                rotations, shs, colors_precomp,
                                quick_weights, quick_indices, quick_channels,
                                dict(features=features,
                                     cov3d_precomp=cov3d_precomp,
                                     means2d_dummy=means2d_dummy,
                                     stage_events=stage_events),
                                quick_train)
    if cov3d_precomp is None and (scales is None or rotations is None):
        raise ValueError("rasterize needs scales and rotations, or "
                         "cov3d_precomp")
    if dense and quick:
        raise ValueError("features and quick_weights are exclusive modes")
    if xla_route(settings, quick, quick_train, dense,
                 cov3d_precomp is not None):
        dev = resolve_device(device)
        return _rasterize_xla(
            settings, means3d, to_f32(opacities, dev), viewmatrix,
            projmatrix, campos, to_f32(bg, dev), scales, rotations,
            cov3d_precomp, shs, colors_precomp, features, quick_weights,
            quick_indices, quick_channels, means2d_dummy, dev, stage_events)
    fast16 = quick and not quick_train and settings.precision == "bf16"
    capped = settings.tile_budget > 0.0 and not fast16 and quick \
        and quick_train and train.capped_fits(quick_weights.shape[1])
    cascaded = settings.binning == "cascade" and not dense \
        and not (quick and quick_train)
    if (quick or dense or cascaded) and means2d_dummy is not None:
        raise ValueError("on the kernel routes means2d_dummy is read in RGB "
                         "mode on the sort binning only")
    dev = resolve_device(device)
    H, W = settings.image_height, settings.image_width
    grid_x, grid_y = settings.grid_x, settings.grid_y
    opacities = to_f32(opacities, dev)
    bg = to_f32(bg, dev).contiguous()
    if dense:
        return _rasterize_dense(settings, means3d, opacities, viewmatrix,
                                projmatrix, campos, bg, scales, rotations,
                                cov3d_precomp, shs, colors_precomp,
                                to_f32(features, dev), dev, stage_events)
    if cascaded:
        return _rasterize_cascade(settings, means3d, opacities, viewmatrix,
                                  projmatrix, campos, bg, scales, rotations,
                                  cov3d_precomp, shs, colors_precomp,
                                  quick_weights, quick_indices,
                                  quick_channels, dev, stage_events)
    if fast16:
        b = fast16_binned(settings, means3d, opacities, viewmatrix,
                          projmatrix, campos, scales, rotations,
                          cov3d_precomp, shs, colors_precomp, quick_weights,
                          quick_indices, dev=dev, stage_events=stage_events)
        with tracing.span("blend"):
            rgb_t, feat_t, t_t = blend.blend_tiles_fast16(
                b.g, b.start, b.count, b.rows, bg, grid_x, grid_y,
                quick_weights.shape[1], quick_channels, settings.feat_bf16,
                cells_bf16=settings.bf16_cells)
        return _assemble(settings, rgb_t, feat_t, t_t, b.proj.radius,
                         b.max_tile_count, b.total, b.live_total,
                         stage_events)

    mark_stage(stage_events, "start")
    with tracing.span("preprocess"):
        proj = projection.preprocess(
            *_per_gaussian(dev, means3d, scales, rotations, shs,
                           colors_precomp), viewmatrix, projmatrix, campos,
            settings.tanfovx, settings.tanfovy, W, H, settings.sh_degree,
            settings.scale_modifier, opacities=opacities[:, 0].detach(),
            cull_alpha=settings.cull_alpha,
            cov3d_precomp=to_f32(cov3d_precomp, dev))
    mark_stage(stage_events, "preprocess")
    # binning is not differentiable
    with torch.no_grad(), tracing.span("binning"):
        proj_d, op_d = projection.detach(proj), opacities[:, 0].detach()
        if capped:
            g_sorted, tile_start, tile_count, sat_bound, total = \
                capped_binning(settings, proj_d, op_d, False, stage_events)
            max_tile_count = sat_bound.max()
            live_total = tile_count.sum(dtype=torch.int32)
        else:
            g_sorted, tile_start, tile_count, total, live_total = \
                sorted_binning(settings, proj_d, op_d, stage_events)
            max_tile_count = tile_count.max()
    mark_stage(stage_events, "budget" if capped else "sort")
    if not quick:
        with tracing.span("blend"):
            rgb, final_t = rgb_train.rasterize_rgb_vjp(
                settings, proj, opacities[:, 0], (g_sorted, tile_start,
                                                  tile_count), bg,
                to_f32(means2d_dummy, dev))
        mark_stage(stage_events, "blend")
        mark_stage(stage_events, "assemble")
        return RasterizeOutput(
            rgb=rgb, feature_map=None, radii=proj.radius,
            final_transmittance=final_t, max_tile_count=max_tile_count,
            total_entries=total, live_total=live_total)
    with tracing.span("blend"):
        qw = to_f32(quick_weights, dev).contiguous()
        qi = torch.as_tensor(quick_indices, device=dev).to(
            torch.int32).contiguous()
        geom = blend.pack_gaussian_state(proj.xy, proj.conic,
                                         opacities[:, 0], proj.rgb)
        if quick_train:
            rgb_t, feat_t, t_t = train.QuickTrainBlend.apply(
                qw, g_sorted, tile_start, tile_count, geom, bg, qi, grid_x,
                grid_y, quick_channels,
                settings.tile_budget_cap if capped else 0)
        else:
            rgb_t, feat_t, t_t = blend.blend_tiles(
                g_sorted, tile_start, tile_count, geom, bg, grid_x, grid_y,
                qw, qi, quick_channels)
    return _assemble(settings, rgb_t, feat_t, t_t, proj.radius,
                     max_tile_count, total, live_total, stage_events)


def _rasterize_gauss(settings, mesh, means3d, opacities, viewmatrix,
                     projmatrix, campos, bg, scales, rotations, shs,
                     colors_precomp, quick_weights, quick_indices,
                     quick_channels, unread: dict, quick_train: bool):
    """binning="gauss" (JAX :192-210): the Gaussian-sharded forward of
    parallel/gauss_sharded.py over `mesh`'s "gauss" axis, each rank
    passing its own rows; whole images on every rank, radii of the rank's
    rows, max_tile_count 0, the exchange's dropped entries. It reads no
    gradient carrier, dense features, covariances or quick_train, and
    raises for them rather than render without them."""
    from ..parallel.gauss_sharded import rasterize_gauss_sharded

    if mesh is None:
        raise ValueError('binning="gauss" needs a 1-D "gauss" mesh '
                         '(parallel.make_gauss_mesh)')
    given = [k for k, v in unread.items() if v is not None]
    if quick_train:
        given.append("quick_train")
    if given:
        raise ValueError(f'binning="gauss" renders forward only and reads '
                         f'none of {given}')
    rgb, feat, final_t, total, dropped, radii = rasterize_gauss_sharded(
        mesh, settings, means3d, opacities, viewmatrix, projmatrix, campos,
        bg, scales=scales, rotations=rotations,
        colors_precomp=colors_precomp, shs=shs,
        quick_weights=quick_weights, quick_indices=quick_indices,
        quick_channels=quick_channels,
        pair_capacity=settings.pair_capacity or None)
    return RasterizeOutput(
        rgb=rgb, feature_map=feat, radii=radii, final_transmittance=final_t,
        max_tile_count=torch.zeros((), dtype=torch.int32, device=rgb.device),
        total_entries=total, dropped_entries=dropped)


def xla_route(settings: RasterizeSettings, quick: bool, quick_train: bool,
              dense: bool, cov3d: bool) -> bool:
    """True when `rasterize` takes the XLA route: under impl="xla"; for a
    quick_train frame with cov3d_precomp under every impl; under
    impl="auto" for dense features and for an RGB frame with
    cov3d_precomp or on binning="cascade" (JAX's "auto" on a TPU)."""
    if settings.impl == "xla":
        return True
    if quick and quick_train:
        return cov3d
    if settings.impl == "pallas" or quick:
        return False
    return dense or cov3d or settings.binning != "sort"


def _rasterize_xla(settings, means3d, opacities, viewmatrix, projmatrix,
                   campos, bg, scales, rotations, cov3d_precomp, shs,
                   colors_precomp, features, quick_weights, quick_indices,
                   quick_channels, means2d_dummy, dev, stage_events):
    """The XLA route (JAX :280-329): preprocess, means2D carrier, quick
    pairs as channels, bin_gaussians, the autograd tile blend, images."""
    H, W = settings.image_height, settings.image_width
    grid_x, grid_y = settings.grid_x, settings.grid_y
    mark_stage(stage_events, "start")
    with tracing.span("preprocess"):
        proj = projection.preprocess(
            *_per_gaussian(dev, means3d, scales, rotations, shs,
                           colors_precomp), viewmatrix, projmatrix, campos,
            settings.tanfovx, settings.tanfovy, W, H, settings.sh_degree,
            settings.scale_modifier,
            cov3d_precomp=to_f32(cov3d_precomp, dev))
    mark_stage(stage_events, "preprocess")
    with tracing.span("binning"):
        binned = binning.bin_gaussians(projection.detach(proj), grid_x,
                                       grid_y, settings.max_entries,
                                       opacities[:, 0])
    mark_stage(stage_events, "sort")
    with tracing.span("blend"):
        xy = proj.xy
        if means2d_dummy is not None:
            # The reference's dL/dmean2D scale, which densification reads.
            scale = torch.tensor([0.5 * W, 0.5 * H], device=dev)
            xy = xy + to_f32(means2d_dummy, dev) * scale
        if quick_weights is not None:
            feats = quick_as_channels(quick_weights, quick_indices,
                                      quick_channels, dev)
        else:
            feats = to_f32(features, dev)
        rgb_t, feat_t, t_t = rasterize_tiles.blend_tiles(
            xy, proj.conic, opacities[:, 0], proj.rgb, feats, binned, grid_x,
            grid_y, bg, settings.tile_cap, settings.tile_batch)
    mark_stage(stage_events, "blend")
    with tracing.span("assemble"):
        rgb = rasterize_tiles.tiles_to_image(rgb_t, grid_x, grid_y, H, W)
        feat = (rasterize_tiles.tiles_to_image(feat_t, grid_x, grid_y, H, W)
                if feat_t is not None else None)
        final_t = rasterize_tiles.tiles_to_image(
            t_t[..., None], grid_x, grid_y, H, W)[0]
    mark_stage(stage_events, "assemble")
    return RasterizeOutput(
        rgb=rgb, feature_map=feat, radii=proj.radius,
        final_transmittance=final_t,
        max_tile_count=binned.tile_count.max(),
        total_entries=binned.total_entries, live_total=None)


def quick_as_channels(quick_weights, quick_indices, channels: int, dev):
    """[N, channels] dense rows of the quick pairs: JAX's one_hot einsum,
    as a scatter_add (out-of-range indices select no channel, as one_hot's
    zero rows do), differentiable in quick_weights."""
    qw = to_f32(quick_weights, dev)
    qi = torch.as_tensor(quick_indices, device=dev).long()
    in_range = (qi >= 0) & (qi < channels)
    feats = torch.zeros((qw.shape[0], channels), device=dev)
    return feats.scatter_add(1, qi.clamp(0, channels - 1),
                             torch.where(in_range, qw, 0.0))


def _rasterize_dense(settings, means3d, opacities, viewmatrix, projmatrix,
                     campos, bg, scales, rotations, cov3d_precomp, shs,
                     colors_precomp, features, dev, stage_events):
    """Dense features: K1, the sort, K2's dense mode in DenseTrainBlend.
    Without cov3d_precomp, the custom VJP's binning (pallas_train.py
    :462-505: default cull, no live clamp, the map always assembled, no
    live_total); with it, `_rasterize_pallas`'s dense branch."""
    vjp = cov3d_precomp is None
    if vjp:
        defaults = RasterizeSettings._field_defaults
        settings = settings._replace(cull_alpha=defaults["cull_alpha"],
                                     live_entries=0, assemble=True)
    proj, op = _preprocess_frozen(
        settings, means3d, opacities, viewmatrix, projmatrix, campos, scales,
        rotations, cov3d_precomp, shs, colors_precomp, dev, stage_events)
    with torch.no_grad(), tracing.span("binning"):
        g_sorted, tile_start, tile_count, total, live_total = \
            sorted_binning(settings, proj, op, stage_events)
    mark_stage(stage_events, "sort")
    with tracing.span("blend"):
        with torch.no_grad():
            geom = blend.pack_gaussian_state(proj.xy, proj.conic, op,
                                             proj.rgb)
        rgb_t, feat_t, t_t = train.DenseTrainBlend.apply(
            features.contiguous(), g_sorted, tile_start, tile_count, geom,
            bg, settings.grid_x, settings.grid_y)
    return _assemble(settings, rgb_t, feat_t, t_t, proj.radius,
                     tile_count.max(), total, None if vjp else live_total,
                     stage_events)


def _rasterize_cascade(settings, means3d, opacities, viewmatrix, projmatrix,
                       campos, bg, scales, rotations, cov3d_precomp, shs,
                       colors_precomp, quick_weights, quick_indices,
                       quick_channels, dev, stage_events):
    """binning="cascade" (`_rasterize_pallas` :369-397): K8's segments
    blended by K2's f32 mode (rgb or quick), forward only. JAX's cascade
    culls at alpha 1/255 whatever cull_alpha says (the rects follow it)."""
    proj, op = _preprocess_frozen(
        settings, means3d, opacities, viewmatrix, projmatrix, campos, scales,
        rotations, cov3d_precomp, shs, colors_precomp, dev, stage_events)
    with torch.no_grad():
        with tracing.span("binning"):
            g, start, count, total, overflow = cascade.cascade_binning(
                proj, op, settings.grid_x, settings.grid_y,
                settings.max_entries, inv_cull_alpha=255.0)
            total = torch.where(overflow, torch.clamp(
                total, min=settings.max_entries), total)
        mark_stage(stage_events, "sort")
        with tracing.span("blend"):
            geom = blend.pack_gaussian_state(proj.xy, proj.conic, op,
                                             proj.rgb)
            if quick_weights is None:
                rgb_t, feat_t, t_t = blend.blend_tiles(
                    g, start, count, geom, bg, settings.grid_x,
                    settings.grid_y)
            else:
                rgb_t, feat_t, t_t = blend.blend_tiles(
                    g, start, count, geom, bg, settings.grid_x,
                    settings.grid_y, to_f32(quick_weights, dev).contiguous(),
                    torch.as_tensor(quick_indices, device=dev).to(
                        torch.int32).contiguous(), quick_channels)
    return _assemble(settings, rgb_t, feat_t, t_t, proj.radius, count.max(),
                     total, None, stage_events)


def _assemble(settings, rgb_t, feat_t, t_t, radii, max_tile_count, total,
              live_total, stage_events) -> RasterizeOutput:
    """The quick modes' tail: the tiles to images (the feature map only
    with settings.assemble)."""
    mark_stage(stage_events, "blend")
    H, W = settings.image_height, settings.image_width
    grid_x, grid_y = settings.grid_x, settings.grid_y
    with tracing.span("assemble"):
        rgb = rasterize_tiles.tiles_to_image(rgb_t, grid_x, grid_y, H, W)
        if settings.assemble and feat_t is not None:
            feat_t = rasterize_tiles.tiles_to_image(feat_t, grid_x, grid_y,
                                                    H, W)
        final_t = rasterize_tiles.tiles_to_image(
            t_t[..., None], grid_x, grid_y, H, W)[0]
    mark_stage(stage_events, "assemble")
    return RasterizeOutput(
        rgb=rgb, feature_map=feat_t, radii=radii,
        final_transmittance=final_t, max_tile_count=max_tile_count,
        total_entries=total, live_total=live_total)


def rasterize_quick_query(settings: RasterizeSettings, means3d, opacities,
                          viewmatrix, projmatrix, campos, bg, scales=None,
                          rotations=None, shs=None, colors_precomp=None,
                          quick_weights=None, quick_indices=None, phi=None,
                          gram=None, quick_channels: int = 192, *,
                          device=None, stage_events: list | None = None):
    """The serving frame with the Gram query fused into the blend: fast16
    rows, sorted binning with the live-prefix clamp, or the capped windows
    when tile_budget > 0 (the budget read from the rows' bf16-rounded conic
    and opacity, kept clamped to tile_cap). phi [L, K, PQ] and gram
    [L, K, K] are the prompt constants (eval/openclip.py), L*K =
    quick_channels. Returns (rgb [3, H, W], raw [T, 256, L*PQ], nrm2
    [T, 256, L], final_T [H, W], radii [N], total_entries [], live_total
    []); on the capped route live_total is the kept total. Stage events
    as for `rasterize` ("blend" includes the query)."""
    check_slice(settings)
    dev = resolve_device(device)
    phi, gram = to_f32(phi, dev), to_f32(gram, dev)
    L, K, _ = phi.shape
    if quick_channels != L * K:
        raise ValueError(f"quick_channels {quick_channels} != L*K = "
                         f"{L * K} of phi {tuple(phi.shape)}")
    H, W = settings.image_height, settings.image_width
    grid_x, grid_y = settings.grid_x, settings.grid_y
    b = fast16_binned(settings, means3d, opacities, viewmatrix, projmatrix,
                      campos, scales, rotations, None, shs, colors_precomp,
                      quick_weights, quick_indices, dev=dev,
                      stage_events=stage_events)
    with torch.no_grad():
        with tracing.span("blend"):
            rgb_t, raw, nrm2, t_t = blend.blend_tiles_query(
                b.g, b.start, b.count, b.rows, to_f32(bg, dev).contiguous(),
                grid_x, grid_y, quick_weights.shape[1], phi.contiguous(),
                gram.contiguous(), cells_bf16=settings.bf16_cells)
        mark_stage(stage_events, "blend")
        with tracing.span("assemble"):
            rgb = rasterize_tiles.tiles_to_image(rgb_t, grid_x, grid_y, H, W)
            final_t = rasterize_tiles.tiles_to_image(
                t_t[..., None], grid_x, grid_y, H, W)[0]
        mark_stage(stage_events, "assemble")
    return rgb, raw, nrm2, final_t, b.proj.radius, b.total, b.live_total
