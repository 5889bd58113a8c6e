"""Gaussian-sharded rasterization over a binning all-to-all (port of
langsplatv2_tpu/parallel/gauss_sharded.py on torch.distributed).

Each of the C ranks of the "gauss" mesh owns N/C Gaussians (it passes
only its own rows) and a contiguous strip of ceil(T / C) tiles:

1. It preprocesses its rows (opacity-aware rects) and expands them with
   K1's exact cull (`ops/expand.py`) into ceil(max_entries / C) slots.
2. One stable local sort by the int64 key tile << 31 | depth bits groups
   the entries by destination: owners hold contiguous strips, so rank d's
   segment is [lower(d * strip), lower((d + 1) * strip)), the bounds
   clamped to the local total (which counts the cull's sentinel entries,
   as JAX's does).
3. Each segment is cut at the pair capacity (JAX's default ceil(budget /
   max(C // 2, 1)), rounded up to 128) and its entries' blend rows (x y
   conic opacity rgb, then tile and depth, then the quick pairs) go out in
   fixed-capacity blocks through `all_to_all_single`; dead slots carry the
   sentinel tile. What a pair's segment holds past the capacity is
   dropped and counted.
4. The receiver sorts what it got by the same key and blends its strip
   with K2's f32 modes from tile_base = rank * strip (`ops/blend.py`); the
   received rows are the blend state (g_sorted = arange(E)).

Order. JAX sorts by (tile, depth, global id) with 2 or 3 u32 key words
(`_key_words`); the port's int64 key with a stable sort gives that order
for any grid and N, so the key width has no counterpart here. On the
sender the stable sort keeps the entries' Gaussian-major order, which is
global-id order within a rank. On the receiver the blocks arrive in
source-rank order, each in its sender's sorted order, and global ids grow
with the rank: a stable (tile, depth) sort then breaks ties by global id,
as JAX's key does.

The sentinel. Where C * strip > T, the last segment's bound lies past the
sentinel tile T, so the cull's sentinel entries go to the rank whose strip
holds slot T, count against its capacity and in `dropped`, as in JAX. That
slot and any later one blend as empty; their outputs lie past the grid.

Overflow is counted, never silent: `dropped` sums max(count - capacity, 0)
over every (source, destination) pair, and `total` the ranks' expansion
totals.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tracing
from ..ops import blend, expand, projection, rasterize_tiles, train
from ..ops.rasterize import RasterizeSettings, to_f32
from .distributed import all_gather, all_reduce_, all_to_all
from .sharding import Mesh

GEOM_W = 9       # x y conic(3) opacity r g b
TILE_COL, DEPTH_COL = GEOM_W, GEOM_W + 1
PAIRS_COL = GEOM_W + 2
GRAD_W = 128     # JAX's replay rows: quick channels the training path takes


class Exchange(NamedTuple):
    """The receiver's blend state and the routing the backward needs."""

    geom: torch.Tensor         # [E, 9] f32 received rows, sorted
    qw: torch.Tensor | None    # [E, S] f32
    qi: torch.Tensor | None    # [E, S] i32
    tile: torch.Tensor         # [E] i64 sorted tiles (T = sentinel)
    tile_start: torch.Tensor   # [strip] i32
    tile_count: torch.Tensor   # [strip] i32
    tile_base: int
    perm2: torch.Tensor        # [E] receive order of each sorted row
    flat_idx: torch.Tensor     # [C * cap] the sent slots' local entries
    live: torch.Tensor         # [C * cap] sent slots that carry an entry
    src_g: torch.Tensor        # [budget] i64 local Gaussian of each entry
    total: torch.Tensor        # [] i32 local expansion total
    dcount: torch.Tensor       # [C] i32 each destination's segment length
    dropped: torch.Tensor      # [] i32 local overflow


def plan(settings: RasterizeSettings, c: int,
         pair_capacity: int | None) -> dict:
    """The static sizes: tiles a strip, the local budget and the pair
    capacity (JAX's rule)."""
    num_tiles = settings.grid_x * settings.grid_y
    local_budget = -(-settings.max_entries // c)
    cap = pair_capacity or -(-local_budget // max(c // 2, 1))
    return dict(num_tiles=num_tiles, strip=-(-num_tiles // c),
                local_budget=local_budget, cap=-(-cap // 128) * 128)


def _sort(tile: torch.Tensor, depth: torch.Tensor):
    """Stable sort by tile << 31 | depth bits: (sorted tiles i64, perm)."""
    key = (tile.long() << 31) | (depth.view(torch.int32).long() & 0x7FFFFFFF)
    key_s, perm = torch.sort(key, stable=True)
    return key_s >> 31, perm


def _expand_exchange(proj, op, qw, qi, *, mesh: Mesh, axis: str, sizes: dict,
                     grid_x: int, grid_y: int) -> Exchange:
    """K1 on the rank's rows, the local sort, the capped segments and the
    all-to-all, then the receiver's sort and its strip's tile ranges."""
    c, rank = mesh.shape[axis], mesh.coords[axis]
    group = mesh.groups[axis]
    num_tiles, strip = sizes["num_tiles"], sizes["strip"]
    budget, cap = sizes["local_budget"], sizes["cap"]
    dev = op.device
    quick = qw is not None

    tile, depth, gauss_l, total = expand.expand_entries(
        proj, op, grid_x, grid_y, budget, exact_cull=True)
    tile_s, perm = _sort(tile, depth)
    src_g = gauss_l[perm].long()
    starts = torch.arange(c + 1, device=dev, dtype=torch.int64) * strip
    dbounds = torch.clamp(torch.searchsorted(tile_s, starts),
                          max=total.long())
    dcount = dbounds[1:] - dbounds[:-1]
    dropped = torch.clamp(dcount - cap, min=0).sum().to(torch.int32)

    slot = torch.arange(cap, device=dev)
    live = (slot[None, :] < torch.clamp(dcount, max=cap)[:, None]).reshape(-1)
    flat_idx = torch.clamp(dbounds[:-1, None] + slot[None, :],
                           max=budget - 1).reshape(-1)
    g = src_g[flat_idx]
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, op, proj.rgb)
    tile_bits = tile_s[flat_idx].to(torch.int32).view(torch.float32)
    cols = [geom[g], tile_bits[:, None], depth[perm[flat_idx]][:, None]]
    if quick:
        cols += [qw[g], qi[g].view(torch.float32)]
    send = torch.where(live[:, None], torch.cat(cols, dim=1), 0.0)
    sentinel = torch.tensor(num_tiles, dtype=torch.int32,
                            device=dev).view(torch.float32)
    send[:, TILE_COL] = torch.where(live, send[:, TILE_COL], sentinel)

    recv = all_to_all(send, group)                       # [C * cap, width]
    tile2_s, perm2 = _sort(recv[:, TILE_COL].view(torch.int32),
                           recv[:, DEPTH_COL])
    rows = recv[perm2]
    t0 = rank * strip
    bounds = torch.searchsorted(
        tile2_s, t0 + torch.arange(strip + 1, device=dev, dtype=torch.int64))
    s = qw.shape[1] if quick else 0
    return Exchange(
        geom=rows[:, :GEOM_W].contiguous(),
        qw=rows[:, PAIRS_COL:PAIRS_COL + s].contiguous() if quick else None,
        qi=(rows[:, PAIRS_COL + s:].contiguous().view(torch.int32)
            if quick else None),
        tile=tile2_s, tile_start=bounds[:-1].to(torch.int32),
        tile_count=(bounds[1:] - bounds[:-1]).to(torch.int32), tile_base=t0,
        perm2=perm2, flat_idx=flat_idx, live=live, src_g=src_g,
        total=total.to(torch.int32), dcount=dcount.to(torch.int32),
        dropped=dropped)


def _preprocess(settings, means3d, opacities, viewmatrix, projmatrix, campos,
                scales, rotations, colors_precomp, shs, dev):
    """The rank's rows' preprocess (SH evaluated in the shard), without
    gradients; returns (proj, opacities [n_loc])."""
    n = means3d.shape[0]
    op = to_f32(opacities, dev)[:, 0].contiguous()
    use_shs = colors_precomp is None and shs is not None
    scales = to_f32(scales, dev) if scales is not None else torch.ones(
        (n, 3), device=dev)
    if rotations is None:
        rotations = torch.cat([torch.ones((n, 1)), torch.zeros((n, 3))], 1)
    cols = None if use_shs else (
        to_f32(colors_precomp, dev) if colors_precomp is not None
        else torch.zeros((n, 3), device=dev))
    proj = projection.preprocess(
        to_f32(means3d, dev), scales, to_f32(rotations, dev),
        projection.shs_f32(shs, dev) if use_shs else None, cols,
        viewmatrix, projmatrix, campos, settings.tanfovx, settings.tanfovy,
        settings.image_width, settings.image_height, settings.sh_degree,
        settings.scale_modifier, opacities=op)
    return projection.detach(proj), op


def _sum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    return all_reduce_(x.clone(), mesh.groups[axis])


def exchange(mesh: Mesh, settings: RasterizeSettings, means3d, opacities,
             viewmatrix, projmatrix, campos, scales=None, rotations=None,
             colors_precomp=None, shs=None, quick_weights=None,
             quick_indices=None, *, axis: str = "gauss",
             pair_capacity: int | None = None, stats: dict | None = None):
    """Steps 1-3 and the receiver's sort for the rank's rows (a collective:
    every rank of `axis` calls it): returns (Exchange, the rows'
    preprocess). `stats`, if a dict, gets the exchange's sizes: "cap",
    "local_budget", "strip", "tile_base", "local_total" (this rank's
    expansion total), "dcount" (its segment lengths by destination),
    "received" (live rows it received)."""
    dev = mesh.device
    sizes = plan(settings, mesh.shape[axis], pair_capacity)
    quick = quick_weights is not None
    with torch.no_grad():
        with tracing.span("preprocess"):
            proj, op = _preprocess(settings, means3d, opacities, viewmatrix,
                                   projmatrix, campos, scales, rotations,
                                   colors_precomp, shs, dev)
        with tracing.span("binning"):
            qw = (to_f32(quick_weights, dev).detach().contiguous() if quick
                  else None)
            qi = (torch.as_tensor(quick_indices, device=dev).to(torch.int32)
                  .contiguous() if quick else None)
            ex = _expand_exchange(proj, op, qw, qi, mesh=mesh, axis=axis,
                                  sizes=sizes, grid_x=settings.grid_x,
                                  grid_y=settings.grid_y)
    if stats is not None:
        stats.update(cap=sizes["cap"], local_budget=sizes["local_budget"],
                     strip=sizes["strip"], tile_base=ex.tile_base,
                     local_total=ex.total, dcount=ex.dcount,
                     received=(ex.tile < sizes["num_tiles"]).sum())
    return ex, proj


def strip_images(tiles, mesh: Mesh, settings: RasterizeSettings,
                 axis: str = "gauss"):
    """The strips [strip, 256, C] of every rank of `axis` gathered, cut to
    the grid and laid out as a [C, H, W] image."""
    full = all_gather(tiles, mesh.groups[axis])
    return rasterize_tiles.tiles_to_image(
        full[:settings.grid_x * settings.grid_y], settings.grid_x,
        settings.grid_y, settings.image_height, settings.image_width)


def rasterize_gauss_sharded(
    mesh: Mesh,
    settings: RasterizeSettings,
    means3d, opacities, viewmatrix, projmatrix, campos, bg,
    scales=None, rotations=None, colors_precomp=None, shs=None,
    quick_weights=None, quick_indices=None, quick_channels: int = 192,
    *,
    axis: str = "gauss",
    pair_capacity: int | None = None,
    gather: bool = True,
    stats: dict | None = None,
):
    """Forward render with the Gaussians sharded over the mesh's `axis`:
    every rank passes its own rows (N/C of them, rank r holding global
    rows r*N/C ..). Colours come precomputed or as SH coefficients `shs`
    [n, B, 3], evaluated in the shard. Quick mode with quick_weights /
    quick_indices [n, S].

    Returns (rgb, feature_map | None, final_T, total_entries [],
    dropped_entries [], radii [n] of the rank's rows). With `gather` the
    images are whole ([3, H, W], [C, H, W], [H, W]) on every rank (JAX's
    global arrays); without, the rank's strip in tile layout ([strip, 256,
    3], [strip, 256, C], [strip, 256]) from grid tile rank * strip on.
    dropped_entries > 0: a (source, destination) pair overflowed the pair
    capacity. `stats` as for `exchange`."""
    quick = quick_weights is not None
    ex, proj = exchange(mesh, settings, means3d, opacities, viewmatrix,
                        projmatrix, campos, scales, rotations,
                        colors_precomp, shs, quick_weights, quick_indices,
                        axis=axis, pair_capacity=pair_capacity, stats=stats)
    with torch.no_grad():
        with tracing.span("blend"):
            g = torch.arange(ex.geom.shape[0], dtype=torch.int32,
                             device=mesh.device)
            rgb_t, feat_t, t_t = blend.blend_tiles(
                g, ex.tile_start, ex.tile_count, ex.geom,
                to_f32(bg, mesh.device).contiguous(), settings.grid_x,
                settings.grid_y, ex.qw, ex.qi, quick_channels if quick else 0,
                tile_base=ex.tile_base)
        total = _sum(ex.total, mesh, axis)
        dropped = _sum(ex.dropped, mesh, axis)
        if gather:
            with tracing.span("assemble"):
                rgb_t = strip_images(rgb_t, mesh, settings, axis)
                feat_t = (strip_images(feat_t, mesh, settings, axis)
                          if quick else None)
                t_t = strip_images(t_t[..., None], mesh, settings, axis)[0]
    return rgb_t, feat_t, t_t, total, dropped, proj.radius


class _GaussFeatureTrain(torch.autograd.Function):
    """The Gaussian-sharded quick blend whose only gradient is
    d(quick_weights) of the rank's rows (the feature phase's contract);
    the exchange happened before, its rows are the blend state. Backward
    (JAX's local_bwd): K4 on the received sorted entries, zeroed on the
    sentinel tile; un-sorted by perm2; the reverse all-to-all (the
    forward's transpose); the live mask; one index_add_ onto the local
    rows by src_g[flat_idx]; a gather at each row's top-k lanes."""

    @staticmethod
    def forward(ctx, quick_weights, ex: Exchange, quick_indices, bg,
                grid_x, grid_y, channels, num_tiles, group):
        g = torch.arange(ex.geom.shape[0], dtype=torch.int32,
                         device=ex.geom.device)
        rgb_t, feat_t, t_t = blend.blend_tiles(
            g, ex.tile_start, ex.tile_count, ex.geom, bg, grid_x, grid_y,
            ex.qw, ex.qi, channels, tile_base=ex.tile_base)
        ctx.ex, ctx.g = ex, g
        ctx.save_for_backward(quick_indices)
        ctx.args = (grid_x, grid_y, channels, num_tiles, group,
                    quick_weights.shape[0])
        ctx.mark_non_differentiable(rgb_t, t_t)
        return rgb_t, feat_t, t_t

    @staticmethod
    def backward(ctx, _g_rgb, g_feat, _g_t):
        none = (None,) * 8
        if g_feat is None:
            return (None,) + none
        (qi,) = ctx.saved_tensors
        ex = ctx.ex
        grid_x, grid_y, k, num_tiles, group, n_loc = ctx.args
        dfeat = train.feature_grads(ctx.g, ex.tile_start, ex.tile_count,
                                    ex.geom, g_feat.contiguous(), grid_x,
                                    grid_y, tile_base=ex.tile_base)
        dfeat = torch.where((ex.tile < num_tiles)[:, None], dfeat, 0.0)
        recv_grad = torch.empty_like(dfeat)
        recv_grad[ex.perm2] = dfeat
        back = all_to_all(recv_grad, group)
        contrib = torch.where(ex.live[:, None], back, 0.0)
        d_dense = torch.zeros((n_loc, k), device=dfeat.device).index_add_(
            0, ex.src_g[ex.flat_idx], contrib)
        in_range = (qi >= 0) & (qi < k)
        d_qw = torch.where(in_range, d_dense.gather(
            1, qi.long().clamp(0, k - 1)), 0.0)
        return (d_qw,) + none


def rasterize_gauss_sharded_feature_train(
    mesh: Mesh,
    settings: RasterizeSettings,
    means3d, opacities, viewmatrix, projmatrix, campos, bg,
    quick_weights, quick_indices, quick_channels: int,
    scales=None, rotations=None, colors_precomp=None, shs=None,
    *,
    axis: str = "gauss",
    pair_capacity: int | None = None,
    stats: dict | None = None,
):
    """The feature phase's training render with the Gaussians sharded
    over `axis` (rows as for `rasterize_gauss_sharded`): the same forward,
    the feature map differentiable in the rank's quick_weights [n, S] and
    in nothing else. Returns the rank's strip (rgb [strip, 256, 3], feat
    [strip, 256, K], final_T [strip, 256]) and total_entries [],
    dropped_entries [] summed over the ranks. Each rank's loss is its
    strip's term of the global loss and every rank runs its backward (the
    backward's all-to-all is a collective): d(quick_weights) is then the
    global loss's gradient for the rank's rows. quick_channels <= 128 (JAX
    trains a level at a time). `stats` as for `exchange`."""
    if quick_channels > GRAD_W:
        raise ValueError(f"quick_channels {quick_channels} > {GRAD_W}: the "
                         "sharded feature step trains a level at a time")
    dev = mesh.device
    qw = to_f32(quick_weights, dev)
    ex, _proj = exchange(mesh, settings, means3d, opacities, viewmatrix,
                         projmatrix, campos, scales, rotations,
                         colors_precomp, shs, qw, quick_indices, axis=axis,
                         pair_capacity=pair_capacity, stats=stats)
    with tracing.span("blend"):
        qi = torch.as_tensor(quick_indices, device=dev).to(torch.int32)
        rgb_t, feat_t, t_t = _GaussFeatureTrain.apply(
            qw, ex, qi, to_f32(bg, dev).contiguous(), settings.grid_x,
            settings.grid_y, quick_channels,
            settings.grid_x * settings.grid_y, mesh.groups[axis])
    return (rgb_t, feat_t, t_t, _sum(ex.total, mesh, axis),
            _sum(ex.dropped, mesh, axis))
