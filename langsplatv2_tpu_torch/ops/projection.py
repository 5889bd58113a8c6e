"""Per-Gaussian preprocessing: cull, EWA projection, conic, radius, tile
rect, SH -> RGB (port of langsplatv2_tpu/ops/projection.py).

Plain batched PyTorch, written op for op in the JAX order so that the
float32 results round the same way: the exact cull of the expansion
kernel (K1) and the tile rects downstream are compared exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import sh as sh_mod
from ..utils.camera_math import ndc_to_pixel

BLOCK = 16  # tile side in pixels


class ProjectedGaussians(NamedTuple):
    xy: torch.Tensor             # [N, 2] pixel-space means
    depth: torch.Tensor          # [N] view-space z
    conic: torch.Tensor          # [N, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor         # [N] int32, 0 = culled
    rgb: torch.Tensor | None     # [N, 3]
    rect_min: torch.Tensor       # [N, 2] int32 inclusive tile min (x, y)
    rect_max: torch.Tensor       # [N, 2] int32 exclusive tile max (x, y)
    tiles_touched: torch.Tensor  # [N] int32


def detach(proj: ProjectedGaussians) -> ProjectedGaussians:
    """The same fields outside autograd (binning reads them)."""
    return ProjectedGaussians(*(None if t is None else t.detach()
                                for t in proj))


def project_gaussians(means3d, scales, rotations, viewmatrix, projmatrix,
                      tanfovx: float, tanfovy: float, image_width: int,
                      image_height: int, scale_modifier: float = 1.0,
                      opacities=None, cull_alpha: float = 1.0 / 255.0, *,
                      cov3d_precomp=None):
    """Returns (xy, depth, conic, radius, ext_x, ext_y); ext_* are None
    without opacities (no opacity-aware tight rect). With cov3d_precomp
    [N, 6] (xx, xy, xz, yy, yz, zz) the world covariance comes from it and
    scales / rotations are not read."""
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]

    def hrow(m, j):
        return mx * m[0, j] + my * m[1, j] + mz * m[2, j] + m[3, j]

    pv_x = hrow(viewmatrix, 0)
    pv_y = hrow(viewmatrix, 1)
    depth = hrow(viewmatrix, 2)
    in_front = depth > 0.2

    p_w = 1.0 / (hrow(projmatrix, 3) + 1e-7)
    p_proj_x = hrow(projmatrix, 0) * p_w
    p_proj_y = hrow(projmatrix, 1) * p_w

    focal_x = image_width / (2.0 * tanfovx)
    focal_y = image_height / (2.0 * tanfovy)
    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    tz = depth
    tx = torch.clamp(pv_x / tz, -limx, limx) * tz
    ty = torch.clamp(pv_y / tz, -limy, limy) * tz

    W = viewmatrix[:3, :3].T
    j0 = (focal_x / tz)[:, None]
    j2 = (-focal_x * tx / (tz * tz))[:, None]
    k1 = (focal_y / tz)[:, None]
    k2 = (-focal_y * ty / (tz * tz))[:, None]
    m0 = j0 * W[0][None, :] + j2 * W[2][None, :]
    m1 = k1 * W[1][None, :] + k2 * W[2][None, :]
    if cov3d_precomp is not None:
        # m . Sigma . m' from the 6 unique entries, in JAX's op order.
        xx, xy_, xz, yy, yz, zz = cov3d_precomp.unbind(-1)

        def quad(p, q):
            return (p[:, 0] * q[:, 0] * xx + p[:, 1] * q[:, 1] * yy
                    + p[:, 2] * q[:, 2] * zz
                    + (p[:, 0] * q[:, 1] + p[:, 1] * q[:, 0]) * xy_
                    + (p[:, 0] * q[:, 2] + p[:, 2] * q[:, 0]) * xz
                    + (p[:, 1] * q[:, 2] + p[:, 2] * q[:, 1]) * yz)

        a = quad(m0, m0) + 0.3
        b = quad(m0, m1)
        c = quad(m1, m1) + 0.3
    else:
        qn = rotations / torch.linalg.norm(rotations, dim=-1, keepdim=True)
        r, x, y, z = qn[:, 0], qn[:, 1], qn[:, 2], qn[:, 3]
        R00 = 1 - 2 * (y * y + z * z)
        R01 = 2 * (x * y - r * z)
        R02 = 2 * (x * z + r * y)
        R10 = 2 * (x * y + r * z)
        R11 = 1 - 2 * (x * x + z * z)
        R12 = 2 * (y * z - r * x)
        R20 = 2 * (x * z - r * y)
        R21 = 2 * (y * z + r * x)
        R22 = 1 - 2 * (x * x + y * y)
        s2 = torch.square(scale_modifier * scales)
        u0 = m0[:, 0] * R00 + m0[:, 1] * R10 + m0[:, 2] * R20
        u1 = m0[:, 0] * R01 + m0[:, 1] * R11 + m0[:, 2] * R21
        u2 = m0[:, 0] * R02 + m0[:, 1] * R12 + m0[:, 2] * R22
        v0 = m1[:, 0] * R00 + m1[:, 1] * R10 + m1[:, 2] * R20
        v1 = m1[:, 0] * R01 + m1[:, 1] * R11 + m1[:, 2] * R21
        v2 = m1[:, 0] * R02 + m1[:, 1] * R12 + m1[:, 2] * R22
        a = s2[:, 0] * u0 * u0 + s2[:, 1] * u1 * u1 + s2[:, 2] * u2 * u2 + 0.3
        b = s2[:, 0] * u0 * v0 + s2[:, 1] * u1 * v1 + s2[:, 2] * u2 * v2
        c = s2[:, 0] * v0 * v0 + s2[:, 1] * v1 * v1 + s2[:, 2] * v2 * v2 + 0.3

    det = a * c - b * b
    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam))

    xy = torch.stack([ndc_to_pixel(p_proj_x, image_width),
                      ndc_to_pixel(p_proj_y, image_height)], dim=-1)
    visible = in_front & det_ok
    radius = torch.where(visible, radius_f, 0.0).to(torch.int32)
    if opacities is None:
        return xy, depth, conic, radius, None, None

    # Opacity-aware per-axis extents (alpha >= cull_alpha only within
    # |dx| <= sqrt(2 ln(op/cull_alpha) cov_xx)), intersected with the
    # 3-sigma square.
    two_l = 2.0 * torch.log(torch.clamp(opacities, min=1e-12) / cull_alpha)
    dead = two_l <= 0.0
    ext_x = torch.ceil(torch.sqrt(torch.clamp(two_l * a, min=0.0))) + 1.0
    ext_y = torch.ceil(torch.sqrt(torch.clamp(two_l * c, min=0.0))) + 1.0
    ext_x = torch.where(dead, 0.0, torch.minimum(radius_f, ext_x))
    ext_y = torch.where(dead, 0.0, torch.minimum(radius_f, ext_y))
    keep = visible & ~dead
    ext_x = torch.where(keep, ext_x, 0.0)
    ext_y = torch.where(keep, ext_y, 0.0)
    radius = torch.where(dead, 0, radius)
    return xy, depth, conic, radius, ext_x, ext_y


def tile_rect(xy, radius, image_width: int, image_height: int,
              ext_x=None, ext_y=None):
    """Inclusive-min / exclusive-max touched tile rect (CUDA getRect)."""
    grid_x = (image_width + BLOCK - 1) // BLOCK
    grid_y = (image_height + BLOCK - 1) // BLOCK
    rx = radius.float() if ext_x is None else ext_x
    ry = radius.float() if ext_y is None else ext_y

    def cell(v, hi):
        return torch.clamp(torch.floor(v / BLOCK), 0, hi).to(torch.int32)

    rect_min = torch.stack([cell(xy[:, 0] - rx, grid_x),
                            cell(xy[:, 1] - ry, grid_y)], dim=-1)
    rect_max = torch.stack([cell(xy[:, 0] + rx + BLOCK - 1, grid_x),
                            cell(xy[:, 1] + ry + BLOCK - 1, grid_y)], dim=-1)
    tiles = ((rect_max[:, 0] - rect_min[:, 0])
             * (rect_max[:, 1] - rect_min[:, 1]))
    empty = (rx <= 0.0) | (ry <= 0.0)
    tiles = torch.where(empty, 0, tiles).to(torch.int32)
    return rect_min, rect_max, tiles


def sh_to_color(shs, means3d, campos, sh_degree: int):
    """View-dependent SH colour, clamped at 0. shs [N, K, 3]."""
    dirs = means3d - campos[None, :]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    result = sh_mod.eval_sh(sh_degree, shs.transpose(-1, -2), dirs)
    return torch.clamp(result + 0.5, min=0.0)


def preprocess(means3d, scales, rotations, shs, colors_precomp, viewmatrix,
               projmatrix, campos, tanfovx: float, tanfovy: float,
               image_width: int, image_height: int, sh_degree: int,
               scale_modifier: float = 1.0, opacities=None,
               cull_alpha: float = 1.0 / 255.0, *,
               cov3d_precomp=None) -> ProjectedGaussians:
    xy, depth, conic, radius, ext_x, ext_y = project_gaussians(
        means3d, scales, rotations, viewmatrix, projmatrix, tanfovx, tanfovy,
        image_width, image_height, scale_modifier, opacities=opacities,
        cull_alpha=cull_alpha, cov3d_precomp=cov3d_precomp)
    rect_min, rect_max, tiles = tile_rect(
        xy, radius, image_width, image_height, ext_x=ext_x, ext_y=ext_y)
    radius = torch.where(tiles > 0, radius, 0)
    tiles = torch.where(radius > 0, tiles, 0)
    if colors_precomp is not None:
        rgb = colors_precomp
    elif shs is not None:
        rgb = sh_to_color(shs, means3d, campos, sh_degree)
    else:
        rgb = None
    return ProjectedGaussians(xy, depth, conic, radius, rgb, rect_min,
                              rect_max, tiles)
