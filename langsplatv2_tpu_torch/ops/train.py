"""Quick-mode rasterization for feature-phase training: the K2 forward with
a W-replay backward, kernel K4 (port of langsplatv2_tpu/ops/pallas_train.py
:39-247 and :588-904, the exact route: `feature_grads_pallas` and the
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
slow), not in Pallas. The kernel is bound by its dF write and cotangent read;
csrc/feature_bwd.cu says how its design meets that.
"""
from __future__ import annotations

import torch

from . import blend, kernels
from .blend import P


def feature_grads_plain(g_sorted, tile_start, tile_count, geom, cot, grid_x):
    """dF [E, C] for the cotangent cot [T, 256, C] of the quick map; rows no
    tile blends are 0."""
    dfeat = torch.zeros((g_sorted.shape[0], cot.shape[2]), device=cot.device)
    for j, live, _g, _row, w, _T in blend.replay_positions(
            g_sorted, tile_start, tile_count, geom, grid_x):
        rows = torch.einsum("tp,tpc->tc", w, cot)
        dfeat[(tile_start + j)[live].long()] = rows[live]
    return dfeat


def feature_grads(g_sorted, tile_start, tile_count, geom, cot, grid_x: int,
                  grid_y: int):
    """Per-entry feature gradients dF [E, C] (E = len(g_sorted)) of the
    quick map's cotangent cot [T, 256, C], T = grid_x * grid_y. Inputs as
    for `blend.blend_tiles`. Rows of entries that no tile blends are 0."""
    dev = cot.device
    n_tiles = grid_x * grid_y
    if dev.type == "cpu":
        return feature_grads_plain(g_sorted, tile_start, tile_count, geom,
                                   cot, grid_x)
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
                   ptr(tile_count), ptr(geom), ptr(cot), n_tiles, grid_x, c,
                   e, ptr(dfeat), kernels.stream(dfeat))
    feature_grads.launches += 1
    return dfeat


feature_grads.launches = 0


def reduce_to_gaussians(dfeat, g_sorted, quick_indices):
    """d_qw [N, S]: each entry's gradient at its Gaussian's own top-k
    channels, summed over the Gaussian's entries (the VJP of K2's channel
    scatter)."""
    g = g_sorted.long()
    proj = dfeat.gather(1, quick_indices[g].long())            # [E, S]
    return torch.zeros(quick_indices.shape, device=dfeat.device).index_add_(
        0, g, proj)


class QuickTrainBlend(torch.autograd.Function):
    """K2 quick blend whose only gradient is d(quick_weights), through K4.
    Every other input is binning state or frozen geometry and gets none
    (the feature-phase contract of pallas_train.py:750-755, :791-796)."""

    @staticmethod
    def forward(ctx, quick_weights, g_sorted, tile_start, tile_count, geom,
                bg, quick_indices, grid_x, grid_y, channels):
        rgb_t, feat_t, t_t = blend.blend_tiles(
            g_sorted, tile_start, tile_count, geom, bg, grid_x, grid_y,
            quick_weights.contiguous(), quick_indices, channels)
        ctx.save_for_backward(g_sorted, tile_start, tile_count, geom,
                              quick_indices)
        ctx.grid = (grid_x, grid_y)
        ctx.mark_non_differentiable(rgb_t, t_t)
        return rgb_t, feat_t, t_t

    @staticmethod
    def backward(ctx, _g_rgb, g_feat, _g_t):
        none = (None,) * 9
        if g_feat is None:
            return (None,) + none
        g_sorted, tile_start, tile_count, geom, quick_indices = \
            ctx.saved_tensors
        dfeat = feature_grads(g_sorted, tile_start, tile_count, geom,
                              g_feat.contiguous(), *ctx.grid)
        return (reduce_to_gaussians(dfeat, g_sorted, quick_indices),) + none
