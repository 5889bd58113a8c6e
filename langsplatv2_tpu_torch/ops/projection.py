"""Per-Gaussian preprocessing: cull, EWA projection, conic, radius, tile
rect, SH -> RGB (port of langsplatv2_tpu/ops/projection.py).

`preprocess` takes one of three paths by what the call can observe:

- CUDA tensors, and no input needs a gradient (grad mode off, or no input
  requires_grad): one launch of csrc/preprocess.cu (`preprocess_kernel`).
  The camera enters the launch by value from host arrays (no device copy,
  so no stream synchronisation), or through device pointers when it is
  given as CUDA tensors. Every serving route and the feature step, whose
  geometry is frozen, take it.
- CUDA tensors that need a gradient, and neither colors_precomp,
  cov3d_precomp nor the camera does: `PreprocessGrad` (`preprocess_grad`),
  the same launch as the forward and one launch of csrc/preprocess_bwd.cu
  as the backward, the camera passed to both by value. The geometry step
  takes it.
- Otherwise `preprocess_plain`: batched PyTorch, written op for op in the
  JAX order so that the float32 results round the same way (the exact
  cull of the expansion kernel (K1) and the tile rects downstream are
  compared exactly). It is the CPU path, and the autograd route of the
  calls whose colours or covariances need a gradient
  (`compute_cov3d_python`, `convert_shs_python`).

The kernel's outputs are the plain path's on the card bit for bit
(csrc/preprocess.cu says how); the backward kernel's gradients are
autograd's through the plain path to summation order, and
`preprocess_grads_plain` is its plain twin. The counters (tracing.py)
"preprocess.launches" count the forward kernel's launches,
"preprocess.grad_launches" the backward kernel's, and
"preprocess.plain_calls" the plain path's calls on CUDA tensors; the
backward launch runs in the span "preprocess_bwd".

`shs` is [N, K, 3] or the pair (features_dc [N, 1, 3], features_rest
[N, K - 1, 3]), which the kernels read in place and the plain path
concatenates.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace
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


def _ewa_terms(means3d, scales, rotations, viewmatrix, projmatrix,
               tanfovx: float, tanfovy: float, image_width: int,
               image_height: int, scale_modifier: float = 1.0,
               cov3d_precomp=None) -> SimpleNamespace:
    """The EWA projection's intermediate values, op for op as
    `project_gaussians` computes them (its outputs and its adjoint's masks
    read them): the view-space point, the projection, the clamped
    tx / ty, the J rows' products m0 / m1 and a, b, c of the 2D
    covariance; with scales and rotations also the normalised quaternion
    and its norm, R, s^2, u = R^T m0 and v = R^T m1."""
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]

    def hrow(m, j):
        return mx * m[0, j] + my * m[1, j] + mz * m[2, j] + m[3, j]

    t = SimpleNamespace()
    t.pv_x = hrow(viewmatrix, 0)
    t.pv_y = hrow(viewmatrix, 1)
    t.depth = hrow(viewmatrix, 2)

    t.h_x, t.h_y = hrow(projmatrix, 0), hrow(projmatrix, 1)
    t.p_w = 1.0 / (hrow(projmatrix, 3) + 1e-7)
    t.p_proj_x = t.h_x * t.p_w
    t.p_proj_y = t.h_y * t.p_w

    t.focal_x = image_width / (2.0 * tanfovx)
    t.focal_y = image_height / (2.0 * tanfovy)
    t.limx = 1.3 * tanfovx
    t.limy = 1.3 * tanfovy
    tz = t.depth
    t.wx, t.wy = t.pv_x / tz, t.pv_y / tz
    t.tx = torch.clamp(t.wx, -t.limx, t.limx) * tz
    t.ty = torch.clamp(t.wy, -t.limy, t.limy) * tz

    W = viewmatrix[:3, :3].T
    j0 = (t.focal_x / tz)[:, None]
    j2 = (-t.focal_x * t.tx / (tz * tz))[:, None]
    k1 = (t.focal_y / tz)[:, None]
    k2 = (-t.focal_y * t.ty / (tz * tz))[:, None]
    m0 = t.m0 = j0 * W[0][None, :] + j2 * W[2][None, :]
    m1 = t.m1 = k1 * W[1][None, :] + k2 * W[2][None, :]
    if cov3d_precomp is not None:
        # m . Sigma . m' from the 6 unique entries, in JAX's op order.
        xx, xy_, xz, yy, yz, zz = cov3d_precomp.unbind(-1)

        def quad(p, q):
            return (p[:, 0] * q[:, 0] * xx + p[:, 1] * q[:, 1] * yy
                    + p[:, 2] * q[:, 2] * zz
                    + (p[:, 0] * q[:, 1] + p[:, 1] * q[:, 0]) * xy_
                    + (p[:, 0] * q[:, 2] + p[:, 2] * q[:, 0]) * xz
                    + (p[:, 1] * q[:, 2] + p[:, 2] * q[:, 1]) * yz)

        t.a = quad(m0, m0) + 0.3
        t.b = quad(m0, m1)
        t.c = quad(m1, m1) + 0.3
    else:
        t.qnorm = torch.linalg.norm(rotations, dim=-1, keepdim=True)
        qn = t.qn = rotations / t.qnorm
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
        t.R = ((R00, R01, R02), (R10, R11, R12), (R20, R21, R22))
        s2 = t.s2 = torch.square(scale_modifier * scales)
        u0 = m0[:, 0] * R00 + m0[:, 1] * R10 + m0[:, 2] * R20
        u1 = m0[:, 0] * R01 + m0[:, 1] * R11 + m0[:, 2] * R21
        u2 = m0[:, 0] * R02 + m0[:, 1] * R12 + m0[:, 2] * R22
        v0 = m1[:, 0] * R00 + m1[:, 1] * R10 + m1[:, 2] * R20
        v1 = m1[:, 0] * R01 + m1[:, 1] * R11 + m1[:, 2] * R21
        v2 = m1[:, 0] * R02 + m1[:, 1] * R12 + m1[:, 2] * R22
        t.u, t.v = (u0, u1, u2), (v0, v1, v2)
        t.a = (s2[:, 0] * u0 * u0 + s2[:, 1] * u1 * u1 + s2[:, 2] * u2 * u2
               + 0.3)
        t.b = s2[:, 0] * u0 * v0 + s2[:, 1] * u1 * v1 + s2[:, 2] * u2 * v2
        t.c = (s2[:, 0] * v0 * v0 + s2[:, 1] * v1 * v1 + s2[:, 2] * v2 * v2
               + 0.3)
    t.det = t.a * t.c - t.b * t.b
    t.det_ok = t.det != 0.0
    return t


def project_gaussians(means3d, scales, rotations, viewmatrix, projmatrix,
                      tanfovx: float, tanfovy: float, image_width: int,
                      image_height: int, scale_modifier: float = 1.0,
                      opacities=None, cull_alpha: float = 1.0 / 255.0, *,
                      cov3d_precomp=None):
    """Returns (xy, depth, conic, radius, ext_x, ext_y); ext_* are None
    without opacities (no opacity-aware tight rect). With cov3d_precomp
    [N, 6] (xx, xy, xz, yy, yz, zz) the world covariance comes from it and
    scales / rotations are not read."""
    t = _ewa_terms(means3d, scales, rotations, viewmatrix, projmatrix,
                   tanfovx, tanfovy, image_width, image_height,
                   scale_modifier, cov3d_precomp)
    a, b, c, det, det_ok = t.a, t.b, t.c, t.det, t.det_ok
    depth = t.depth
    in_front = depth > 0.2
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam))

    xy = torch.stack([ndc_to_pixel(t.p_proj_x, image_width),
                      ndc_to_pixel(t.p_proj_y, image_height)], dim=-1)
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


def _sh_dirs(means3d, campos):
    """(the unit directions from the camera centre [N, 3], their lengths
    [N, 1])."""
    dirs = means3d - campos[None, :]
    norm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return dirs / norm, norm


def sh_to_color(shs, means3d, campos, sh_degree: int):
    """View-dependent SH colour, clamped at 0. shs [N, K, 3]."""
    dirs, _ = _sh_dirs(means3d, campos)
    result = sh_mod.eval_sh(sh_degree, shs.transpose(-1, -2), dirs)
    return torch.clamp(result + 0.5, min=0.0)


def shs_f32(shs, dev):
    """`to_f32` of `shs`, a tensor [N, K, 3] or the (dc, rest) pair."""
    if isinstance(shs, tuple):
        return tuple(to_f32(t, dev) for t in shs)
    return to_f32(shs, dev)


def _on_card(t) -> bool:
    return isinstance(t, torch.Tensor) and t.is_cuda


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
    """The kernel for CUDA tensors when no input needs a gradient,
    `PreprocessGrad` when only the geometry and SH inputs do, else the
    plain path (the module docstring). The camera (viewmatrix, projmatrix,
    campos) may be host arrays or tensors."""
    args = (means3d, scales, rotations, shs, colors_precomp, viewmatrix,
            projmatrix, campos, tanfovx, tanfovy, image_width, image_height,
            sh_degree, scale_modifier, opacities, cull_alpha)
    cuda = _on_card(means3d)
    if cuda and not _needs_grad(means3d, scales, rotations, shs,
                                colors_precomp, viewmatrix, projmatrix,
                                campos, opacities, cov3d_precomp):
        return preprocess_kernel(*args, cov3d_precomp=cov3d_precomp)
    if cuda and not _needs_grad(colors_precomp, cov3d_precomp, viewmatrix,
                                projmatrix, campos):
        return preprocess_grad(*args, cov3d_precomp=cov3d_precomp)
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


def preprocess_grads_plain(means3d, scales, rotations, shs, colors_precomp,
                           viewmatrix, projmatrix, campos, tanfovx: float,
                           tanfovy: float, image_width: int,
                           image_height: int, sh_degree: int,
                           scale_modifier: float = 1.0, *, g_xy=None,
                           g_conic=None, g_rgb=None, cov3d_precomp=None):
    """The adjoint of `preprocess_plain` in plain PyTorch, op for op as
    csrc/preprocess_bwd.cu computes it: from the cotangents of xy [N, 2],
    conic [N, 3] and rgb [N, 3] (None is zero), the gradients (d_means3d,
    d_scales, d_rotations, d_shs). d_scales and d_rotations are None with
    cov3d_precomp (which takes no gradient here); d_shs is None without an
    SH colour, else shaped as `shs` (a tensor [N, K, 3] or the (dc, rest)
    pair), 0 past the degree's coefficients. The forward's values are
    recomputed by `_ewa_terms` and `_sh_dirs`, so the masks of autograd
    through the plain path (the tx / ty clamp, det != 0, the colour's clamp
    at 0, all inclusive as torch's are) are the same bits. A Gaussian whose
    cotangents are all 0 gets zero gradients (the kernel skips it). The
    camera may be host arrays or tensors."""
    dev = means3d.device
    view, projm, cam_c = (to_f32(x, dev) for x in (viewmatrix, projmatrix,
                                                    campos))
    n = means3d.shape[0]
    deg = sh_degree if colors_precomp is None and shs is not None else -1
    whole = None
    if deg >= 0:
        whole = (torch.cat(shs, dim=1) if isinstance(shs, tuple)
                 else shs).detach()

    def cot(g, width):
        return torch.zeros((n, width), device=dev) if g is None else \
            g.detach().to(torch.float32)

    gx, gc, gr = cot(g_xy, 2), cot(g_conic, 3), cot(g_rgb, 3)
    if deg < 0:
        gr = torch.zeros_like(gr)
    work = (torch.cat([gx, gc, gr], dim=1) != 0).any(dim=1)
    with torch.no_grad():
        t = _ewa_terms(means3d.detach(), None if scales is None
                       else scales.detach(), None if rotations is None
                       else rotations.detach(), view, projm, tanfovx,
                       tanfovy, image_width, image_height, scale_modifier,
                       None if cov3d_precomp is None
                       else cov3d_precomp.detach())
        tz, a, b, c = t.depth, t.a, t.b, t.c
        # xy = ((p_proj + 1) size - 1) / 2, p_proj = h p_w.
        dpx = (gx[:, 0] * 0.5) * float(image_width)
        dpy = (gx[:, 1] * 0.5) * float(image_height)
        dhx, dhy = dpx * t.p_w, dpy * t.p_w
        dpw = dpx * t.h_x + dpy * t.h_y
        dhw = -dpw * (t.p_w * t.p_w)
        # conic = (c, -b, a) inv_det.
        inv = torch.where(t.det_ok, 1.0 / torch.where(t.det_ok, t.det, 1.0),
                          0.0)
        dinv = (gc[:, 0] * c - gc[:, 1] * b) + gc[:, 2] * a
        ddet = torch.where(t.det_ok, -dinv * (inv * inv), 0.0)
        da = gc[:, 2] * inv + ddet * c
        db = -gc[:, 1] * inv - 2.0 * (b * ddet)
        dc = gc[:, 0] * inv + ddet * a
        # a, b, c -> m0, m1 (and the covariance's factors).
        m0, m1 = t.m0, t.m1
        d_scales = d_rot = None
        if cov3d_precomp is not None:
            xx, xy_, xz, yy, yz, zz = cov3d_precomp.detach().unbind(-1)
            sig = torch.stack([torch.stack([xx, xy_, xz], -1),
                               torch.stack([xy_, yy, yz], -1),
                               torch.stack([xz, yz, zz], -1)], 1)
            sm0 = (sig @ m0[:, :, None])[:, :, 0]
            sm1 = (sig @ m1[:, :, None])[:, :, 0]
            dm0 = 2.0 * da[:, None] * sm0 + db[:, None] * sm1
            dm1 = db[:, None] * sm0 + 2.0 * dc[:, None] * sm1
        else:
            u, v, s2 = torch.stack(t.u, 1), torch.stack(t.v, 1), t.s2
            R = torch.stack([torch.stack(row, 1) for row in t.R], 1)
            ds2 = (da[:, None] * (u * u) + db[:, None] * (u * v)) \
                + dc[:, None] * (v * v)
            du = s2 * (2.0 * da[:, None] * u + db[:, None] * v)
            dv = s2 * (db[:, None] * u + 2.0 * dc[:, None] * v)
            d_scales = ((ds2 * 2.0) * (scales.detach() * scale_modifier)) \
                * scale_modifier
            dm0 = (R @ du[:, :, None])[:, :, 0]
            dm1 = (R @ dv[:, :, None])[:, :, 0]
            dR = (m0[:, :, None] * du[:, None, :]
                  + m1[:, :, None] * dv[:, None, :])
            qn = t.qn
            r, x, y, z = qn.unbind(-1)
            # dR's symmetric and antisymmetric parts.
            sym, asym = dR + dR.transpose(1, 2), dR.transpose(1, 2) - dR
            s01, s02, s12 = sym[:, 0, 1], sym[:, 0, 2], sym[:, 1, 2]
            a10, a02, a21 = asym[:, 0, 1], asym[:, 2, 0], asym[:, 1, 2]
            dqn = torch.stack([
                2.0 * ((z * a10 + y * a02) + x * a21),
                2.0 * (((y * s01 + z * s02) + r * a21)
                       - 2.0 * x * (dR[:, 1, 1] + dR[:, 2, 2])),
                2.0 * (((x * s01 + z * s12) + r * a02)
                       - 2.0 * y * (dR[:, 0, 0] + dR[:, 2, 2])),
                2.0 * (((x * s02 + y * s12) + r * a10)
                       - 2.0 * z * (dR[:, 0, 0] + dR[:, 1, 1]))], -1)
            dot = (qn * dqn).sum(-1, keepdim=True)
            d_rot = (dqn - qn * dot) * (1.0 / t.qnorm)
        # m0 = j0 W0 + j2 W2, m1 = k1 W1 + k2 W2 -> the J entries.
        V = view[:3, :3]
        dj0 = (dm0 * V[:, 0]).sum(-1)
        dj2 = (dm0 * V[:, 2]).sum(-1)
        dk1 = (dm1 * V[:, 1]).sum(-1)
        dk2 = (dm1 * V[:, 2]).sum(-1)
        rz, tz2 = 1.0 / tz, tz * tz
        j0, k1 = rz * t.focal_x, rz * t.focal_y
        j2 = (t.tx * -t.focal_x) / tz2
        k2 = (t.ty * -t.focal_y) / tz2
        rz2 = rz * rz
        dtx = dj2 * (-t.focal_x * rz2)
        dty = dk2 * (-t.focal_y * rz2)
        dtz = -(dj0 * j0 + dk1 * k1) * rz - 2.0 * (dj2 * j2 + dk2 * k2) * rz
        cx = torch.clamp(t.wx, -t.limx, t.limx)
        cy = torch.clamp(t.wy, -t.limy, t.limy)
        dtz = dtz + (dtx * cx + dty * cy)
        dwx = torch.where((t.wx >= -t.limx) & (t.wx <= t.limx), dtx * tz, 0.0)
        dwy = torch.where((t.wy >= -t.limy) & (t.wy <= t.limy), dty * tz, 0.0)
        dpvx, dpvy = dwx * rz, dwy * rz
        dtz = dtz - (dwx * t.wx + dwy * t.wy) * rz
        P = projm[:3]
        d_means = ((dpvx[:, None] * V[:, 0] + dpvy[:, None] * V[:, 1])
                   + dtz[:, None] * V[:, 2]) \
            + ((dhx[:, None] * P[:, 0] + dhy[:, None] * P[:, 1])
               + dhw[:, None] * P[:, 3])
        d_shs = None
        if deg >= 0:
            dirs, dn = _sh_dirs(means3d.detach(), cam_c)
            raw = sh_mod.eval_sh(deg, whole.transpose(-1, -2), dirs) + 0.5
            d_res = torch.where(raw >= 0.0, gr, 0.0)
            d_whole = torch.zeros_like(whole)
            d_dir = torch.zeros_like(dirs)
            for k, (bk, grad_k) in enumerate(sh_mod.eval_sh_basis(deg,
                                                                  dirs)):
                ck = whole[:, k]
                w = (d_res[:, 0] * ck[:, 0] + d_res[:, 1] * ck[:, 1]) \
                    + d_res[:, 2] * ck[:, 2]
                d_whole[:, k] = d_res * bk[:, None]
                d_dir = d_dir + w[:, None] * grad_k
            if deg > 0:
                dot = (dirs * d_dir).sum(-1, keepdim=True)
                d_means = d_means + (d_dir - dirs * dot) * (1.0 / dn)
            d_shs = d_whole
        keep = work[:, None]
        d_means = torch.where(keep, d_means, 0.0)
        if d_scales is not None:
            d_scales = torch.where(keep, d_scales, 0.0)
            d_rot = torch.where(keep, d_rot, 0.0)
        if d_shs is not None:
            d_shs = torch.where(keep[:, :, None], d_shs, 0.0)
            if isinstance(shs, tuple):
                d_shs = (d_shs[:, :1], d_shs[:, 1:])
    return d_means, d_scales, d_rot, d_shs


# csrc/preprocess.cu's `Params`: the camera (view [16], proj [16],
# campos [3]), then these scalars, as float32. csrc/preprocess_bwd.cu
# takes the same host array.
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


class _KernelCall(NamedTuple):
    """What both kernels read of one call: the host `Params` array and the
    camera's device tensors (None for a part given on the host), the
    per-Gaussian inputs as contiguous float32 (scl / rot None with cov;
    dc / rest None without an SH colour), the SH degree (-1: none)."""

    host: np.ndarray
    cam_dev: list
    n: int
    means: torch.Tensor
    scl: torch.Tensor | None
    rot: torch.Tensor | None
    cov: torch.Tensor | None
    op: torch.Tensor | None
    dc: torch.Tensor | None
    rest: torch.Tensor | None
    deg: int


def _kernel_call(means3d, scales, rotations, shs, colors_precomp,
                 viewmatrix, projmatrix, campos, tanfovx, tanfovy,
                 image_width, image_height, sh_degree, scale_modifier,
                 opacities, cull_alpha, cov3d_precomp) -> _KernelCall:
    """The kernels' arguments, after raising on what they do not take."""
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
    return _KernelCall(host, cam_dev, n, means, scl, rot, cov, op, dc, rest,
                       deg)


def _opt(t):
    return kernels.NULL if t is None else kernels.ptr(t)


def _forward_launch(x: _KernelCall, colors_precomp) -> ProjectedGaussians:
    """One launch of csrc/preprocess.cu."""
    dev, n = x.means.device, x.n

    def out(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    xy, depth, conic = out(n, 2), out(n), out(n, 3)
    radius, tiles = out(n, dtype=torch.int32), out(n, dtype=torch.int32)
    rect_min = out(n, 2, dtype=torch.int32)
    rect_max = out(n, 2, dtype=torch.int32)
    rgb = out(n, 3) if x.deg >= 0 else colors_precomp
    P = kernels.ptr
    kernels.launch(
        "lsv2_preprocess", ctypes.c_void_p(x.host.ctypes.data),
        *(_opt(t) for t in x.cam_dev), P(x.means), _opt(x.scl), _opt(x.rot),
        _opt(x.cov), _opt(x.op), _opt(x.dc), _opt(x.rest),
        x.dc.stride(0) if x.dc is not None else 0,
        x.rest.stride(0) if x.rest is not None else 0, x.deg, n, P(xy),
        P(depth), P(conic), P(radius),
        P(rgb) if x.deg >= 0 else kernels.NULL, P(rect_min), P(rect_max),
        P(tiles), kernels.stream(xy))
    tracing.count("preprocess.launches")
    return ProjectedGaussians(xy, depth, conic, radius, rgb, rect_min,
                              rect_max, tiles)


def preprocess_kernel(means3d, scales, rotations, shs, colors_precomp,
                      viewmatrix, projmatrix, campos, tanfovx: float,
                      tanfovy: float, image_width: int, image_height: int,
                      sh_degree: int, scale_modifier: float = 1.0,
                      opacities=None, cull_alpha: float = 1.0 / 255.0, *,
                      cov3d_precomp=None) -> ProjectedGaussians:
    """One launch of csrc/preprocess.cu on CUDA tensors (no autograd):
    `preprocess_plain`'s outputs. colors_precomp comes back as the rgb
    field itself, as on the plain path."""
    x = _kernel_call(means3d, scales, rotations, shs, colors_precomp,
                     viewmatrix, projmatrix, campos, tanfovx, tanfovy,
                     image_width, image_height, sh_degree, scale_modifier,
                     opacities, cull_alpha, cov3d_precomp)
    return _forward_launch(x, colors_precomp)


def _grads_launch(x: _KernelCall, g_xy, g_conic, g_rgb, whole_shs: bool,
                  k_shs: int):
    """One launch of csrc/preprocess_bwd.cu: (d_means, d_scales, d_rot,
    d_shs) as `preprocess_grads_plain` returns them, d_shs one [N, K, 3]
    tensor with `whole_shs`, else the pair; K = k_shs, the coefficients of
    the SH input."""
    dev, n = x.means.device, x.n

    def cot(g, width, name):
        if g is None:
            return None, 0
        g = g.detach().to(torch.float32)
        if g.dim() != 2 or tuple(g.shape) != (n, width):
            raise ValueError(f"{name}: shape {tuple(g.shape)}, expected "
                             f"({n}, {width})")
        if g.device != dev:
            raise ValueError(f"{name}: on {g.device}, expected {dev}")
        if g.stride(1) != 1:
            g = g.contiguous()
        return g, g.stride(0)

    gx, sx = cot(g_xy, 2, "d_xy")
    gc, sc = cot(g_conic, 3, "d_conic")
    gr, sr = cot(g_rgb, 3, "d_rgb") if x.deg >= 0 else (None, 0)
    d_means = torch.empty((n, 3), device=dev)
    d_scales = d_rot = None
    if x.cov is None:
        d_scales = torch.empty((n, 3), device=dev)
        d_rot = torch.empty((n, 4), device=dev)
    d_shs = d_dc = d_rest = None
    if x.deg >= 0:
        # The kernel writes the degree's coefficients; any further ones
        # (an SH input wider than the active degree) stay 0.
        new = torch.zeros if k_shs > (x.deg + 1) ** 2 else torch.empty
        if whole_shs:
            d_shs = new((n, k_shs, 3), device=dev)
            d_dc, d_rest = d_shs[:, :1], d_shs[:, 1:]
        else:
            d_dc = torch.empty((n, 1, 3), device=dev)
            d_rest = new((n, k_shs - 1, 3), device=dev)
            d_shs = (d_dc, d_rest)
    P = kernels.ptr
    kernels.launch(
        "lsv2_preprocess_bwd", ctypes.c_void_p(x.host.ctypes.data),
        *(_opt(t) for t in x.cam_dev), P(x.means), _opt(x.scl), _opt(x.rot),
        _opt(x.cov), _opt(x.dc), _opt(x.rest),
        x.dc.stride(0) if x.dc is not None else 0,
        x.rest.stride(0) if x.rest is not None else 0, x.deg, n, _opt(gx),
        _opt(gc), _opt(gr), sx, sc, sr, P(d_means), _opt(d_scales),
        _opt(d_rot), _opt(d_dc), _opt(d_rest),
        d_dc.stride(0) if d_dc is not None else 0,
        d_rest.stride(0) if d_rest is not None else 0,
        kernels.stream(d_means))
    tracing.count("preprocess.grad_launches")
    return d_means, d_scales, d_rot, d_shs


def _k_shs(shs) -> int:
    if isinstance(shs, tuple):
        return shs[0].shape[1] + shs[1].shape[1]
    return shs.shape[1]


def preprocess_grads_kernel(means3d, scales, rotations, shs, colors_precomp,
                            viewmatrix, projmatrix, campos, tanfovx: float,
                            tanfovy: float, image_width: int,
                            image_height: int, sh_degree: int,
                            scale_modifier: float = 1.0, *, g_xy=None,
                            g_conic=None, g_rgb=None, cov3d_precomp=None):
    """One launch of csrc/preprocess_bwd.cu on CUDA tensors:
    `preprocess_grads_plain`'s gradients."""
    x = _kernel_call(means3d, scales, rotations, shs, colors_precomp,
                     viewmatrix, projmatrix, campos, tanfovx, tanfovy,
                     image_width, image_height, sh_degree, scale_modifier,
                     None, 1.0 / 255.0, cov3d_precomp)
    return _grads_launch(x, g_xy, g_conic, g_rgb,
                         not isinstance(shs, tuple),
                         _k_shs(shs) if x.deg >= 0 else 0)


class PreprocessGrad(torch.autograd.Function):
    """csrc/preprocess.cu's forward and csrc/preprocess_bwd.cu's backward
    as one autograd node: the inputs (means3d, scales, rotations, dc,
    rest) differentiable, dc the whole [N, K, 3] SH tensor when rest is
    None; `call` holds `_kernel_call`'s arguments from colors_precomp to
    cull_alpha. Returns (xy, depth, conic, radius, rect_min,
    rect_max, tiles_touched[, rgb]); depth, radius, the rects and
    tiles_touched carry no gradient, and neither does cov3d_precomp."""

    @staticmethod
    def forward(ctx, call: tuple, means3d, scales, rotations, dc, rest,
                cov3d_precomp):
        shs = None if dc is None else (dc if rest is None else (dc, rest))
        x = _kernel_call(means3d, scales, rotations, shs, *call,
                         cov3d_precomp)
        proj = _forward_launch(x, None)
        ctx.call, ctx.whole = x, rest is None
        ctx.k_shs = _k_shs(shs) if x.deg >= 0 else 0
        ctx.set_materialize_grads(False)
        outs = (proj.xy, proj.depth, proj.conic, proj.radius, proj.rect_min,
                proj.rect_max, proj.tiles_touched)
        ctx.mark_non_differentiable(*(outs[i] for i in (1, 3, 4, 5, 6)))
        return outs + ((proj.rgb,) if x.deg >= 0 else ())

    @staticmethod
    def backward(ctx, g_xy, _g_depth, g_conic, *rest_grads):
        g_rgb = rest_grads[4] if ctx.call.deg >= 0 else None
        with tracing.span("preprocess_bwd"):
            d_means, d_scales, d_rot, d_shs = _grads_launch(
                ctx.call, g_xy, g_conic, g_rgb, ctx.whole, ctx.k_shs)
        d_dc = d_rest = None
        if d_shs is not None:
            d_dc, d_rest = (d_shs, None) if ctx.whole else d_shs
        return None, d_means, d_scales, d_rot, d_dc, d_rest, None


def preprocess_grad(means3d, scales, rotations, shs, colors_precomp,
                    viewmatrix, projmatrix, campos, tanfovx: float,
                    tanfovy: float, image_width: int, image_height: int,
                    sh_degree: int, scale_modifier: float = 1.0,
                    opacities=None, cull_alpha: float = 1.0 / 255.0, *,
                    cov3d_precomp=None) -> ProjectedGaussians:
    """`preprocess_kernel`'s outputs under autograd through
    `PreprocessGrad`: gradients reach means3d, scales, rotations and the
    SH input (a tensor or the (dc, rest) pair). colors_precomp and
    cov3d_precomp take none (`preprocess` routes a call where they need
    one to the plain path); colors_precomp comes back as the rgb field."""
    dc = rest = None
    if colors_precomp is None and shs is not None:
        dc, rest = shs if isinstance(shs, tuple) else (shs, None)
    op = None if opacities is None else opacities.detach()
    call = (colors_precomp, viewmatrix, projmatrix, campos, tanfovx, tanfovy,
            image_width, image_height, sh_degree, scale_modifier, op,
            cull_alpha)
    outs = PreprocessGrad.apply(call, means3d, scales, rotations, dc, rest,
                                cov3d_precomp)
    xy, depth, conic, radius, rect_min, rect_max, tiles = outs[:7]
    rgb = outs[7] if len(outs) > 7 else colors_precomp
    return ProjectedGaussians(xy, depth, conic, radius, rgb, rect_min,
                              rect_max, tiles)
