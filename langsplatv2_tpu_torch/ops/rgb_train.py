"""RGB-mode rasterization for geometry-phase training: the K2 forward with a
front-to-back replay backward, kernel K7 (port of
langsplatv2_tpu/ops/pallas_rgb_train.py: `rgb_grads_pallas`, the custom VJP
of `rgb_blend_core`, here `RGBTrainBlend`, and `rasterize_rgb_vjp`, which
`ops/rasterize.py::rasterize` calls for RGB mode).

The blend runs with bg = 0; the background is composited outside, under
autograd, so that d(final T) carries the background path. The backward
builds one [T, 256, 5] pack per pixel: the colour cotangent g (3),
sdot = C . g of the forward's colour, and gT T_final, the product of
dL/dT_final and T_final (the only form K7 reads them in). K7 turns it into per-entry rows [E, 9] = d(x, y, conic a/b/c, opacity, r, g, b), and
one `index_add_` by g_sorted reduces them to the Gaussians: the columns are
`blend.pack_gaussian_state`'s. (The JAX package sorts the rows back and
takes segment sums by cumsum because TPU scatters are slow; the atomic
`index_add_` sums in another order, so the two agree to rounding.)

`rgb_grads` launches csrc/rgb_bwd.cu on CUDA tensors and runs
`rgb_grads_plain`, the blend's per-position loop vectorized over tiles and
pixels, on CPU tensors. Binning stays outside autograd, as in the CUDA
rasterizer; projection, SH and covariance are plain torch under autograd.
"""
from __future__ import annotations

import torch

from . import blend, kernels, rasterize_tiles
from .blend import ALPHA_MAX, P

N_GRAD = 9       # dx dy dca dcb dcc dop dr dg db
PACK_W = 5       # g_rgb(3) sdot gT*t_final


def rgb_grads_plain(g_sorted, tile_start, tile_count, geom, pack, grid_x):
    """Per-entry rows [sum(tile_count), 9], in K7's sequence of f32 ops."""
    dev = geom.device
    n_tiles = tile_start.shape[0]
    out = torch.zeros((int(tile_count.sum()), N_GRAD), device=dev)
    px, py = blend.pixel_coords(n_tiles, grid_x, dev)
    g_rgb = pack[..., 0:3]
    sdot = pack[..., 3]
    gtt = pack[..., 4]
    t_before = torch.ones((n_tiles, P), device=dev)
    pref = torch.zeros((n_tiles, P), device=dev)
    for j, live, _g, row, w, t_after in blend.replay_positions(
            g_sorted, tile_start, tile_count, geom, grid_x):
        inc = w > 0.0
        dx = px - row[:, 0:1]
        dy = py - row[:, 1:2]
        ca, cb, cc, op = row[:, 2:3], row[:, 3:4], row[:, 4:5], row[:, 5:6]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        expp = torch.exp(power)
        raw = op * expp
        alpha = torch.clamp(raw, max=ALPHA_MAX)
        cg = (row[:, None, 6] * g_rgb[..., 0] + row[:, None, 7] * g_rgb[..., 1]
              + row[:, None, 8] * g_rgb[..., 2])
        pref = pref + torch.where(inc, w * cg, 0.0)
        inv_om = 1.0 / (1.0 - alpha)
        d_alpha = t_before * cg - (sdot - pref) * inv_om - gtt * inv_om
        d_pow = d_alpha * raw
        cols = torch.stack([
            d_pow * (ca * dx + cb * dy), d_pow * (cb * dx + cc * dy),
            d_pow * (-0.5 * dx * dx), d_pow * (-dx * dy),
            d_pow * (-0.5 * dy * dy), d_alpha * expp], dim=-1)
        cols = torch.where((inc & (raw < ALPHA_MAX))[..., None], cols, 0.0)
        drgb = torch.where(inc[..., None], w[..., None] * g_rgb, 0.0)
        rows = torch.cat([cols, drgb], dim=-1).sum(1)           # [T, 9]
        out[(tile_start + j)[live].long()] = rows[live]
        t_before = t_after
    return out


def rgb_grads(g_sorted, tile_start, tile_count, geom, pack, grid_x: int,
              grid_y: int):
    """Per-entry gradient rows [E, 9], E = sum(tile_count) (the entries the
    tiles blend, a prefix of g_sorted), columns d(x, y, ca, cb, cc, op, r,
    g, b). pack [T, 256, 5]: g_rgb(3), sdot, dL/dT_final * T_final;
    T = grid_x * grid_y. Other inputs as for `blend.blend_tiles`."""
    dev = pack.device
    n_tiles = grid_x * grid_y
    if dev.type == "cpu":
        return rgb_grads_plain(g_sorted, tile_start, tile_count, geom, pack,
                               grid_x)
    if dev.type != "cuda":
        raise ValueError(f"rgb_grads: unsupported device {dev}")
    kernels.check_tensor(g_sorted, "g_sorted", torch.int32, (None,), dev)
    kernels.check_tensor(tile_start, "tile_start", torch.int32, (n_tiles,),
                         dev)
    kernels.check_tensor(tile_count, "tile_count", torch.int32, (n_tiles,),
                         dev)
    kernels.check_tensor(geom, "geom", torch.float32, (geom.shape[0], 9), dev)
    kernels.check_tensor(pack, "pack", torch.float32, (n_tiles, P, PACK_W),
                         dev)
    n = int(tile_count.sum())
    if n > g_sorted.shape[0]:
        raise ValueError(f"tile ranges cover {n} entries, g_sorted has "
                         f"{g_sorted.shape[0]}")
    dgrad = torch.empty((n, N_GRAD), device=dev)
    ptr = kernels.ptr
    kernels.launch("lsv2_rgb_bwd", ptr(g_sorted), ptr(tile_start),
                   ptr(tile_count), ptr(geom), ptr(pack), n_tiles, grid_x,
                   ptr(dgrad), kernels.stream(dgrad))
    rgb_grads.launches += 1
    return dgrad


rgb_grads.launches = 0


def make_pack(rgb_t, t_t, g_rgb, g_t):
    """[T, 256, 5]: g_rgb(3), sdot = rgb_t . g_rgb, g_t * t_t."""
    sdot = (rgb_t * g_rgb).sum(-1, keepdim=True)
    return torch.cat([g_rgb, sdot, (g_t * t_t)[..., None]], dim=-1)


def reduce_to_gaussians(dgrad, g_sorted, n: int):
    """[n, 9] per-Gaussian sums of the entry rows."""
    return torch.zeros((n, N_GRAD), device=dgrad.device).index_add_(
        0, g_sorted[:dgrad.shape[0]].long(), dgrad)


class RGBTrainBlend(torch.autograd.Function):
    """K2 rgb blend (bg = 0) differentiable in xy, conic, opacity and
    colour through K7; binning arrays get no gradient. Returns (rgb_t
    [T, 256, 3] without background, final_t [T, 256])."""

    @staticmethod
    def forward(ctx, xy, conic, opacity, rgb, g_sorted, tile_start,
                tile_count, grid_x, grid_y):
        geom = blend.pack_gaussian_state(xy, conic, opacity, rgb)
        zero_bg = torch.zeros(3, device=geom.device)
        rgb_t, _, t_t = blend.blend_tiles(g_sorted, tile_start, tile_count,
                                          geom, zero_bg, grid_x, grid_y)
        ctx.save_for_backward(g_sorted, tile_start, tile_count, geom, rgb_t,
                              t_t)
        ctx.grid = (grid_x, grid_y)
        return rgb_t, t_t

    @staticmethod
    def backward(ctx, g_rgb, g_t):
        g_sorted, tile_start, tile_count, geom, rgb_t, t_t = ctx.saved_tensors
        if g_rgb is None:
            g_rgb = torch.zeros_like(rgb_t)
        if g_t is None:
            g_t = torch.zeros_like(t_t)
        pack = make_pack(rgb_t, t_t, g_rgb, g_t)
        dgrad = rgb_grads(g_sorted, tile_start, tile_count, geom, pack,
                          *ctx.grid)
        per = reduce_to_gaussians(dgrad, g_sorted, geom.shape[0])
        return (per[:, 0:2], per[:, 2:5], per[:, 5], per[:, 6:9]) + \
            (None,) * 5


def rasterize_rgb_vjp(settings, proj, opacity, binning, bg,
                      means2d_dummy=None):
    """The RGB-mode tail of `rasterize` (pallas_rgb_train.py:445-476):
    the means2D carrier xy + dummy * [W/2, H/2] (the reference's
    dL/dmean2D scale, which the densification statistics read), the blend
    core and the background composited outside it. `binning` is
    (g_sorted, tile_start, tile_count). Returns (rgb [3, H, W], final_t
    [H, W])."""
    H, W = settings.image_height, settings.image_width
    grid_x, grid_y = settings.grid_x, settings.grid_y
    xy = proj.xy
    if means2d_dummy is not None:
        scale = torch.tensor([0.5 * W, 0.5 * H], device=xy.device)
        xy = xy + means2d_dummy * scale
    rgb_t, t_t = RGBTrainBlend.apply(xy, proj.conic, opacity, proj.rgb,
                                     *binning, grid_x, grid_y)
    rgb = rasterize_tiles.tiles_to_image(rgb_t, grid_x, grid_y, H, W)
    final_t = rasterize_tiles.tiles_to_image(t_t[..., None], grid_x, grid_y,
                                             H, W)[0]
    return rgb + final_t[None] * bg[:, None, None], final_t
