"""The per-pixel oracle rasterizer, O(pixels x N), differentiable (port of
langsplatv2_tpu/ops/rasterize_reference.py).

The executable specification the tile routes are held against. A
Gaussian adds to a pixel only if the pixel's tile lies in its tile rect;
the blend order is depth, then Gaussian index (a stable sort, culled
Gaussians last); alpha = min(0.99, opacity * exp(power)), skipped when
power > 0 or alpha < 1/255; a Gaussian is applied only while T * (1 -
alpha) >= 1e-4; the background goes onto RGB only. The transmittance is
exp of the exclusive cumsum of log1p(-alpha), as in JAX.

Autograd through this function gives the oracle's gradients; the order
and the tile decisions are taken outside autograd. `means2d_dummy` [N, 2]
carries the screen-space gradient in NDC units (the pixel offset is
dummy * [W/2, H/2]). Pixels go in chunks of rows, so that the [pixels, N]
temporaries stay bounded; no user path calls this oracle.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .projection import BLOCK, preprocess

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
CHUNK_ELEMENTS = 1 << 22   # pixels x Gaussians a chunk


def _blend_weights_for_pixel(px, py, order_xy, order_conic, order_opacity,
                             order_covers):
    """Blend weights w [..., M] = alpha * T and the included alphas over
    the depth-sorted list, for pixels at (px, py) [...] (pixel centre =
    index)."""
    dx = order_xy[:, 0] - px[..., None]
    dy = order_xy[:, 1] - py[..., None]
    a, b, c = order_conic[:, 0], order_conic[:, 1], order_conic[:, 2]
    power = -0.5 * (a * dx ** 2 + c * dy ** 2) - b * dx * dy
    alpha = torch.clamp(order_opacity * torch.exp(power), max=ALPHA_MAX)
    valid = order_covers & (power <= 0.0) & (alpha >= ALPHA_MIN)
    alpha = torch.where(valid, alpha, 0.0)
    # Transmittance before Gaussian j: the product over i < j of 1 - alpha.
    log_t = torch.cumsum(torch.log1p(-alpha), -1) - torch.log1p(-alpha)
    T = torch.exp(log_t)
    include = valid & (T * (1.0 - alpha) >= T_EPS)
    w = torch.where(include, alpha * T, 0.0)
    alpha_included = torch.where(include, alpha, 0.0)
    return w, alpha_included


def rasterize_reference(means3d, opacities, scales, rotations,
                        cov3d_precomp, shs, colors_precomp, features,
                        viewmatrix, projmatrix, campos, tanfovx: float,
                        tanfovy: float, image_width: int, image_height: int,
                        sh_degree: int, bg, scale_modifier: float = 1.0,
                        means2d_dummy=None, *, device=None):
    """Returns (rgb [3, H, W], feature_map [D, H, W] or None, radii [N],
    final_T [H, W]); JAX's argument order, plus `device` (CUDA unless
    "cpu")."""
    dev = resolve_device(device)

    def f32(x):
        return None if x is None else torch.as_tensor(
            x, dtype=torch.float32, device=dev)

    H, W = image_height, image_width
    means3d = f32(means3d)
    proj = preprocess(
        means3d, f32(scales), f32(rotations), f32(shs), f32(colors_precomp),
        f32(viewmatrix), f32(projmatrix), f32(campos), tanfovx, tanfovy, W,
        H, sh_degree, scale_modifier, cov3d_precomp=f32(cov3d_precomp))
    xy = proj.xy
    if means2d_dummy is not None:
        scale = torch.tensor([0.5 * W, 0.5 * H], device=dev)
        xy = xy + f32(means2d_dummy) * scale

    # Depth-stable order over all N (culled Gaussians last).
    with torch.no_grad():
        sort_depth = torch.where(proj.radius > 0, proj.depth, torch.inf)
        order = torch.argsort(sort_depth, stable=True)
    o_xy = xy[order]
    o_conic = proj.conic[order]
    o_op = f32(opacities)[:, 0][order]
    o_rgb = proj.rgb[order]
    o_feat = f32(features)[order] if features is not None else None
    rect_min = proj.rect_min[order]
    rect_max = proj.rect_max[order]
    o_live = proj.radius[order] > 0
    bg = f32(bg)

    n = max(int(order.shape[0]), 1)
    rows = max(1, min(H, CHUNK_ELEMENTS // (n * W)))
    xs = torch.arange(W, device=dev)
    rgb_rows, feat_rows, t_rows = [], [], []
    for y0 in range(0, H, rows):
        ys = torch.arange(y0, min(H, y0 + rows), device=dev)
        py = ys[:, None].expand(-1, W)                      # [R, W]
        px = xs[None, :].expand(ys.shape[0], -1)
        tx = torch.div(px, BLOCK, rounding_mode="floor")[..., None]
        ty = torch.div(py, BLOCK, rounding_mode="floor")[..., None]
        covers = (o_live & (rect_min[:, 0] <= tx) & (tx < rect_max[:, 0])
                  & (rect_min[:, 1] <= ty) & (ty < rect_max[:, 1]))
        w, alpha_incl = _blend_weights_for_pixel(
            px.float(), py.float(), o_xy, o_conic, o_op, covers)
        final_t = torch.exp(torch.sum(torch.log1p(-alpha_incl), -1))
        rgb_rows.append(w @ o_rgb + final_t[..., None] * bg)
        if o_feat is not None:
            feat_rows.append(w @ o_feat)
        t_rows.append(final_t)
    rgb = torch.cat(rgb_rows).permute(2, 0, 1)
    feat = (torch.cat(feat_rows).permute(2, 0, 1) if o_feat is not None
            else None)
    return rgb, feat, proj.radius, torch.cat(t_rows)
