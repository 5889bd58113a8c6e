"""Per-Gaussian preprocessing: cull, EWA projection, conic, radius, tile
rect, SH -> RGB (port of langsplatv2_tpu/ops/projection.py).

`preprocess` takes one of two paths by what the call can observe:

- CUDA tensors, and no input needs a gradient (grad mode off, or no input
  requires_grad): one launch of csrc/preprocess.cu (`preprocess_kernel`).
  The camera enters the launch by value from host arrays (no device copy,
  so no stream synchronisation), or through device pointers when it is
  given as CUDA tensors. Every serving route and the feature step, whose
  geometry is frozen, take it.
- Otherwise `preprocess_plain`: batched PyTorch, written op for op in the
  JAX order so that the float32 results round the same way (the exact
  cull of the expansion kernel (K1) and the tile rects downstream are
  compared exactly). It is the CPU path and the autograd route (geometry
  training differentiates through it).

The kernel's outputs are the plain path's on the card bit for bit
(csrc/preprocess.cu says how). The counters (tracing.py)
"preprocess.launches" count the kernel's launches, and
"preprocess.plain_calls" the plain path's calls on CUDA tensors.

`shs` is [N, K, 3] or the pair (features_dc [N, 1, 3], features_rest
[N, K - 1, 3]), which the kernel reads in place and the plain path
concatenates.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from ..device import to_f32
from ..utils import sh as sh_mod
from ..utils.camera_math import ndc_to_pixel
from . import kernels

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


def shs_f32(shs, dev):
    """`to_f32` of `shs`, a tensor [N, K, 3] or the (dc, rest) pair."""
    if isinstance(shs, tuple):
        return tuple(to_f32(t, dev) for t in shs)
    return to_f32(shs, dev)


def _needs_grad(*xs) -> bool:
    if not torch.is_grad_enabled():
        return False
    for x in xs:
        for t in (x if isinstance(x, tuple) else (x,)):
            if isinstance(t, torch.Tensor) and t.requires_grad:
                return True
    return False


def preprocess(means3d, scales, rotations, shs, colors_precomp, viewmatrix,
               projmatrix, campos, tanfovx: float, tanfovy: float,
               image_width: int, image_height: int, sh_degree: int,
               scale_modifier: float = 1.0, opacities=None,
               cull_alpha: float = 1.0 / 255.0, *,
               cov3d_precomp=None) -> ProjectedGaussians:
    """The kernel for CUDA tensors when no input needs a gradient, else
    the plain path (the module docstring). The camera (viewmatrix,
    projmatrix, campos) may be host arrays or tensors."""
    args = (means3d, scales, rotations, shs, colors_precomp, viewmatrix,
            projmatrix, campos, tanfovx, tanfovy, image_width, image_height,
            sh_degree, scale_modifier, opacities, cull_alpha)
    cuda = isinstance(means3d, torch.Tensor) and means3d.is_cuda
    if cuda and not _needs_grad(means3d, scales, rotations, shs,
                                colors_precomp, viewmatrix, projmatrix,
                                campos, opacities, cov3d_precomp):
        return preprocess_kernel(*args, cov3d_precomp=cov3d_precomp)
    if cuda:
        tracing.count("preprocess.plain_calls")
    return preprocess_plain(*args, cov3d_precomp=cov3d_precomp)


def preprocess_plain(means3d, scales, rotations, shs, colors_precomp,
                     viewmatrix, projmatrix, campos, tanfovx: float,
                     tanfovy: float, image_width: int, image_height: int,
                     sh_degree: int, scale_modifier: float = 1.0,
                     opacities=None, cull_alpha: float = 1.0 / 255.0, *,
                     cov3d_precomp=None) -> ProjectedGaussians:
    """The plain PyTorch preprocess (differentiable)."""
    dev = means3d.device
    viewmatrix, projmatrix, campos = (
        to_f32(x, dev) for x in (viewmatrix, projmatrix, campos))
    if isinstance(shs, tuple):
        shs = torch.cat(shs, dim=1)
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


# csrc/preprocess.cu's `Params`: the camera (view [16], proj [16],
# campos [3]), then these scalars, as float32.
_CAM_FLOATS = 35
_SCALARS = ("focal_x", "focal_y", "lim_x", "lim_y", "width", "height",
            "grid_x", "grid_y", "scale_modifier", "inv_cull_alpha")


def _camera_part(x, size: int, name: str):
    """(host float32 values, None) for a host array or CPU tensor; (None,
    a contiguous float32 CUDA tensor) for a CUDA tensor, which the kernel
    reads through its pointer (never copied to the host)."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        t = x.detach().to(torch.float32).contiguous()
        if t.numel() != size:
            raise ValueError(f"{name}: {t.numel()} values, expected {size}")
        return None, t
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
    a = np.asarray(x, np.float32).reshape(-1)
    if a.size != size:
        raise ValueError(f"{name}: {a.size} values, expected {size}")
    return a, None


def _sh_rows(t, name: str, n: int):
    """An SH tensor [N, k, 3] whose rows the kernel reads at stride
    t.stride(0) (each row's k x 3 values contiguous)."""
    if t.dim() != 3 or t.shape[0] != n or t.shape[2] != 3:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"({n}, k, 3)")
    if t.dtype != torch.float32:
        t = t.float()
    if t.shape[1] > 0 and (t.stride(2) != 1 or t.stride(1) != 3):
        t = t.contiguous()
    return t


def preprocess_kernel(means3d, scales, rotations, shs, colors_precomp,
                      viewmatrix, projmatrix, campos, tanfovx: float,
                      tanfovy: float, image_width: int, image_height: int,
                      sh_degree: int, scale_modifier: float = 1.0,
                      opacities=None, cull_alpha: float = 1.0 / 255.0, *,
                      cov3d_precomp=None) -> ProjectedGaussians:
    """One launch of csrc/preprocess.cu on CUDA tensors (no autograd):
    `preprocess_plain`'s outputs. colors_precomp comes back as the rgb
    field itself, as on the plain path."""
    dev = means3d.device
    n = means3d.shape[0]

    def rows(t, name, width):
        t = t.detach().to(torch.float32).contiguous()
        kernels.check_tensor(t, name, torch.float32, (n, width), dev)
        return t

    means = rows(means3d, "means3d", 3)
    if cov3d_precomp is not None:
        cov, scl, rot = rows(cov3d_precomp, "cov3d_precomp", 6), None, None
    else:
        cov = None
        scl, rot = rows(scales, "scales", 3), rows(rotations, "rotations", 4)
    op = None if opacities is None else \
        opacities.detach().to(torch.float32).contiguous().reshape(n)
    deg, dc, rest = -1, None, None
    if colors_precomp is None and shs is not None:
        if not 0 <= sh_degree <= 4:
            raise ValueError(f"SH degree {sh_degree} is outside 0..4")
        if isinstance(shs, tuple):
            dc, rest = shs
        else:
            dc, rest = shs[:, :1], shs[:, 1:]
        dc = _sh_rows(dc.detach(), "features_dc", n)
        rest = _sh_rows(rest.detach(), "features_rest", n)
        if dc.shape[1] != 1:
            raise ValueError(f"features_dc: {dc.shape[1]} coefficients, "
                             "expected 1")
        if 1 + rest.shape[1] < (sh_degree + 1) ** 2:
            raise ValueError(f"{1 + rest.shape[1]} SH coefficients for "
                             f"degree {sh_degree}")
        deg = sh_degree
    host = np.zeros(_CAM_FLOATS + len(_SCALARS), np.float32)
    cam_dev = []
    at = 0
    for x, size, name in ((viewmatrix, 16, "viewmatrix"),
                          (projmatrix, 16, "projmatrix"),
                          (campos, 3, "campos")):
        a, t = _camera_part(x, size, name)
        if a is not None:
            host[at:at + size] = a
        cam_dev.append(t)
        at += size
    # The f32 each Python scalar of the plain path becomes on the card; a
    # division by a Python scalar is the product with its reciprocal,
    # taken in double and rounded to f32.
    host[at:] = (image_width / (2.0 * tanfovx),
                 image_height / (2.0 * tanfovy), 1.3 * tanfovx,
                 1.3 * tanfovy, image_width, image_height,
                 (image_width + BLOCK - 1) // BLOCK,
                 (image_height + BLOCK - 1) // BLOCK, scale_modifier,
                 1.0 / cull_alpha)

    def out(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    xy, depth, conic = out(n, 2), out(n), out(n, 3)
    radius, tiles = out(n, dtype=torch.int32), out(n, dtype=torch.int32)
    rect_min = out(n, 2, dtype=torch.int32)
    rect_max = out(n, 2, dtype=torch.int32)
    rgb = out(n, 3) if deg >= 0 else colors_precomp
    P = kernels.ptr

    def opt(t):
        return kernels.NULL if t is None else P(t)

    kernels.launch(
        "lsv2_preprocess", ctypes.c_void_p(host.ctypes.data),
        *(opt(t) for t in cam_dev), P(means), opt(scl), opt(rot), opt(cov),
        opt(op), opt(dc), opt(rest), dc.stride(0) if dc is not None else 0,
        rest.stride(0) if rest is not None else 0, deg, n, P(xy), P(depth),
        P(conic), P(radius), P(rgb) if deg >= 0 else kernels.NULL,
        P(rect_min), P(rect_max), P(tiles), kernels.stream(xy))
    tracing.count("preprocess.launches")
    return ProjectedGaussians(xy, depth, conic, radius, rgb, rect_min,
                              rect_max, tiles)
