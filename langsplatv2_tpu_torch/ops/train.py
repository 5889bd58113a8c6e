"""Quick-mode rasterization for feature-phase training: the K2 forward with
a W-replay backward, kernel K4 on the exact route and K5 on the
budget-capped one (port of langsplatv2_tpu/ops/pallas_train.py :39-455 and
:588-904: `feature_grads_pallas`, `feature_grads_topk_pallas` and the
custom VJP of `rasterize_quick_train`, here `QuickTrainBlend`, which
`ops/rasterize.py::rasterize(quick_train=True)` applies).

Geometry is frozen in the feature phase, so the only gradient the loss needs
is d(quick_weights). With feat[p, c] = sum_e W[p, e] * F[e, c] and W the
blend weights (constants with respect to F):

    dF[e, c] = sum_p W[p, e] * g[p, c]                  (K4, per sorted entry)
    d_qw[n, j] = sum over entries e of n of dF[e, qi[n, j]]

`feature_grads` launches csrc/feature_bwd.cu on CUDA tensors and runs
`feature_grads_plain` (the blend's per-position loop accumulating W * g per
entry) on CPU tensors. The projection onto each entry's own top-k channels
and the reduction to Gaussians are a gather and an `index_add_`: the JAX
package did them in XLA (a sort + cumsum there only because TPU scatters are
slow), not in Pallas. The kernel's bound is its dF write and cotangent read;
its cost is the dense product W^T g, which runs on the tensor cores with
f32 accuracy (csrc/feature_bwd.cu says how).

The capped route (settings.tile_budget > 0, top-k width <= 4) blends each
tile's window of `cap` slots (ops/budget.py). Its backward projects first:

    dproj[e, j] = sum_p W[p, e] * g[p, idx_j(e)]        (K5, per window slot)
    d_qw = index_add_ of dproj by the slots' Gaussian ids

`feature_grads_topk` launches csrc/feature_bwd_topk.cu on CUDA tensors and
runs `feature_grads_topk_plain` on CPU tensors.

Dense features (`DenseTrainBlend`, the custom VJP of pallas_train.py
:459-570): K2's dense mode forward; backward K4 on the [T, 256, D]
cotangent (rows of entries no tile blends are 0, as JAX masks entries past
the tiles' ranges, :554-557) and an `index_add_` by g_sorted into
d(features) [N, D]. Every other input gets no gradient (JAX's contract:
zero, :519-522).
"""
from __future__ import annotations

import torch

from . import blend, kernels
from .blend import P


def feature_grads_plain(g_sorted, tile_start, tile_count, geom, cot, grid_x,
                        tile_base: int = 0, grid_tiles: int | None = None):
    """dF [E, C] for the cotangent cot [T, 256, C] of the quick map; rows no
    tile blends are 0. A strip's tiles as `blend.replay_positions` takes
    them."""
    dfeat = torch.zeros((g_sorted.shape[0], cot.shape[2]), device=cot.device)
    tile_count = blend.strip_counts(tile_count, tile_base, grid_tiles)
    for j, live, _g, _row, w, _T in blend.replay_positions(
            g_sorted, tile_start, tile_count, geom, grid_x,
            tile_base=tile_base):
        rows = torch.einsum("tp,tpc->tc", w, cot)
        dfeat[(tile_start + j)[live].long()] = rows[live]
    return dfeat


def feature_grads(g_sorted, tile_start, tile_count, geom, cot, grid_x: int,
                  grid_y: int, *, tile_base: int = 0):
    """Per-entry feature gradients dF [E, C] (E = len(g_sorted)) of the
    quick map's cotangent cot [T, 256, C], T = len(tile_start): the whole
    grid, or with `tile_base` a strip of it. Inputs as for
    `blend.blend_tiles` (a slot at or past the grid blends nothing). Rows
    of entries that no slot blends are 0."""
    dev = cot.device
    grid_tiles = grid_x * grid_y
    n_tiles = tile_start.shape[0]
    if tile_base < 0:
        raise ValueError(f"feature_grads: tile_base {tile_base} < 0")
    if dev.type == "cpu":
        return feature_grads_plain(g_sorted, tile_start, tile_count, geom,
                                   cot, grid_x, tile_base, grid_tiles)
    if dev.type != "cuda":
        raise ValueError(f"feature_grads: unsupported device {dev}")
    n, c, e = geom.shape[0], cot.shape[2], g_sorted.shape[0]
    kernels.check_tensor(g_sorted, "g_sorted", torch.int32, (None,), dev)
    kernels.check_tensor(tile_start, "tile_start", torch.int32, (n_tiles,),
                         dev)
    kernels.check_tensor(tile_count, "tile_count", torch.int32, (n_tiles,),
                         dev)
    kernels.check_tensor(geom, "geom", torch.float32, (n, 9), dev)
    kernels.check_tensor(cot, "cot", torch.float32, (n_tiles, P, c), dev)
    dfeat = torch.empty((e, c), device=dev)
    ptr = kernels.ptr
    kernels.launch("lsv2_feature_bwd", ptr(g_sorted), ptr(tile_start),
                   ptr(tile_count), ptr(geom), ptr(cot), n_tiles, grid_x,
                   tile_base, grid_tiles, c, e, ptr(dfeat),
                   kernels.stream(dfeat))
    feature_grads.launches += 1
    return dfeat


feature_grads.launches = 0


def capped_fits(width: int) -> bool:
    """Whether the capped training route takes a top-k width: the JAX
    package takes it only where x y conic(3) op rgb(3), width/2 index pairs
    and `width` weights fit its 16-wide f32 row (width <= 4); wider codes
    run the exact route whatever the budget."""
    return 9 + width // 2 + width <= 16


def feature_grads_topk_plain(g_win, kept, geom, quick_indices, cot,
                            grid_x, cap):
    """dproj [T*cap, topk] for the capped windows; slots at or past
    kept[t] are 0."""
    n_tiles = kept.shape[0]
    topk = quick_indices.shape[1]
    start = torch.arange(n_tiles, dtype=torch.int32, device=cot.device) * cap
    dproj = torch.zeros((n_tiles * cap, topk), device=cot.device)
    for j, live, g, _row, w, _T in blend.replay_positions(
            g_win, start, kept, geom, grid_x):
        idx = quick_indices[g].long()                           # [T, topk]
        gv = cot.gather(2, idx[:, None, :].expand(-1, P, -1))   # [T, P, topk]
        rows = (w[..., None] * gv).sum(dim=1)
        dproj[(start + j)[live].long()] = rows[live]
    return dproj


def feature_grads_topk(g_win, kept, geom, quick_indices, cot, grid_x: int,
                       grid_y: int, cap: int):
    """Top-k-projected gradients dproj [T*cap, topk] of the capped blend
    (g_win [T*cap] i32 the windows' Gaussian ids, kept [T] i32 <= cap the
    blend counts) for the map's cotangent cot [T, 256, C]; geom as for
    `blend.blend_tiles`, quick_indices [N, topk] i32."""
    dev = cot.device
    n_tiles = grid_x * grid_y
    if dev.type == "cpu":
        return feature_grads_topk_plain(g_win, kept, geom, quick_indices,
                                        cot, grid_x, cap)
    if dev.type != "cuda":
        raise ValueError(f"feature_grads_topk: unsupported device {dev}")
    n, c, topk = geom.shape[0], cot.shape[2], quick_indices.shape[1]
    kernels.check_tensor(g_win, "g_win", torch.int32, (n_tiles * cap,), dev)
    kernels.check_tensor(kept, "kept", torch.int32, (n_tiles,), dev)
    kernels.check_tensor(geom, "geom", torch.float32, (n, 9), dev)
    kernels.check_tensor(quick_indices, "quick_indices", torch.int32,
                         (n, topk), dev)
    kernels.check_tensor(cot, "cot", torch.float32, (n_tiles, P, c), dev)
    dproj = torch.empty((n_tiles * cap, topk), device=dev)
    ptr = kernels.ptr
    kernels.launch("lsv2_feature_bwd_topk", ptr(g_win), ptr(kept), ptr(geom),
                   ptr(quick_indices), ptr(cot), n_tiles, grid_x, cap, c,
                   topk, ptr(dproj), kernels.stream(dproj))
    feature_grads_topk.launches += 1
    return dproj


feature_grads_topk.launches = 0


def reduce_to_gaussians(dfeat, g_sorted, quick_indices):
    """d_qw [N, S]: each entry's gradient at its Gaussian's own top-k
    channels, summed over the Gaussian's entries (the VJP of K2's channel
    scatter)."""
    g = g_sorted.long()
    proj = dfeat.gather(1, quick_indices[g].long())            # [E, S]
    return torch.zeros(quick_indices.shape, device=dfeat.device).index_add_(
        0, g, proj)


class QuickTrainBlend(torch.autograd.Function):
    """K2 quick blend whose only gradient is d(quick_weights), through K4,
    or with cap > 0 (the capped windows: tile t's slots at t*cap) through
    K5. Every other input is binning state or frozen geometry and gets none
    (the feature-phase contract of pallas_train.py:750-755, :791-796)."""

    @staticmethod
    def forward(ctx, quick_weights, g_sorted, tile_start, tile_count, geom,
                bg, quick_indices, grid_x, grid_y, channels, cap=0):
        rgb_t, feat_t, t_t = blend.blend_tiles(
            g_sorted, tile_start, tile_count, geom, bg, grid_x, grid_y,
            quick_weights.contiguous(), quick_indices, channels)
        ctx.save_for_backward(g_sorted, tile_start, tile_count, geom,
                              quick_indices)
        ctx.grid = (grid_x, grid_y)
        ctx.cap = cap
        ctx.mark_non_differentiable(rgb_t, t_t)
        return rgb_t, feat_t, t_t

    @staticmethod
    def backward(ctx, _g_rgb, g_feat, _g_t):
        none = (None,) * 10
        if g_feat is None:
            return (None,) + none
        g_sorted, tile_start, tile_count, geom, quick_indices = \
            ctx.saved_tensors
        if ctx.cap:
            dproj = feature_grads_topk(g_sorted, tile_count, geom,
                                       quick_indices, g_feat.contiguous(),
                                       *ctx.grid, ctx.cap)
            d_qw = torch.zeros(quick_indices.shape, device=dproj.device)
            return (d_qw.index_add_(0, g_sorted.long(), dproj),) + none
        dfeat = feature_grads(g_sorted, tile_start, tile_count, geom,
                              g_feat.contiguous(), *ctx.grid)
        return (reduce_to_gaussians(dfeat, g_sorted, quick_indices),) + none


class DenseTrainBlend(torch.autograd.Function):
    """K2's dense blend whose only gradient is d(features) [N, D], through
    K4 and an index_add_ (the feature-phase contract of
    pallas_train.py:519-522: geometry and binning state get none)."""

    @staticmethod
    def forward(ctx, features, g_sorted, tile_start, tile_count, geom, bg,
                grid_x, grid_y):
        rgb_t, feat_t, t_t = blend.blend_tiles_dense(
            g_sorted, tile_start, tile_count, geom, features, bg, grid_x,
            grid_y)
        ctx.save_for_backward(g_sorted, tile_start, tile_count, geom)
        ctx.grid = (grid_x, grid_y)
        ctx.n = features.shape[0]
        ctx.mark_non_differentiable(rgb_t, t_t)
        return rgb_t, feat_t, t_t

    @staticmethod
    def backward(ctx, _g_rgb, g_feat, _g_t):
        none = (None,) * 7
        if g_feat is None:
            return (None,) + none
        g_sorted, tile_start, tile_count, geom = ctx.saved_tensors
        dfeat = feature_grads(g_sorted, tile_start, tile_count, geom,
                              g_feat.contiguous(), *ctx.grid)
        d_features = torch.zeros((ctx.n, dfeat.shape[1]), device=dfeat.device)
        return (d_features.index_add_(0, g_sorted.long(), dfeat),) + none
