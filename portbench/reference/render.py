"""The reference render: 3DGS's projection (EWA splat, SH colour), the
tile entries in depth order, and the front-to-back blend with its
termination, written from the published method in plain PyTorch.

Semantics (the 3DGS rasterizer's, which the program follows):
- a Gaussian is drawn when its view depth exceeds 0.2, its 2D covariance
  (J W Sigma W^T J^T + 0.3 I, the Jacobian's x/z and y/z clamped at 1.3
  times the half-field tangents) is invertible, its opacity exceeds the
  cull alpha, and its tile rect is not empty;
- its tile rect is the tiles that [xy - e, xy + e] touches, e per axis the
  smaller of the 3-sigma radius (ceil(3 sqrt(largest eigenvalue))) and
  the opacity-aware extent ceil(sqrt(2 ln(op / cull_alpha) cov)) + 1,
  outside which alpha < cull_alpha;
- in a pixel (its centre at the integer index) of a tile, the tile's
  Gaussians come in depth order, ties by index; alpha = min(0.99, op
  exp(power)), skipped when power > 0 or alpha < 1/255; the pixel ends at
  the first Gaussian whose T (1 - alpha) falls under 1e-4, which is not
  applied; the others add alpha T to the blend and multiply T by 1 - alpha.
Entries whose Gaussian reaches no pixel of the tile change nothing, so the
reference keeps the whole rect where the program culls such entries.
"""
from __future__ import annotations

import torch

from .precision import matmul

BLOCK = 16
P = BLOCK * BLOCK
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
GROUP_ELEMENTS = 1 << 24     # pixels x entries a block of tiles holds

# 3DGS's sh_utils constants, degrees 0..3.
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def activate(scene: dict) -> dict:
    """Raw fields -> exp scales, unit quaternions, sigmoid opacities and
    the SH coefficients [N, 16, 3]."""
    q = scene["rotation"]
    return dict(
        xyz=scene["xyz"], scales=torch.exp(scene["scaling"]),
        rot=q / torch.linalg.norm(q, dim=-1, keepdim=True),
        op=1.0 / (1.0 + torch.exp(-scene["opacity"][:, 0])),
        shs=torch.cat([scene["features_dc"], scene["features_rest"]], 1))


def sh_color(shs, xyz, campos, deg: int):
    """View-dependent colour (3DGS computeColorFromSH), clamped at 0."""
    d = xyz - campos[None, :]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    sh = shs
    r = SH_C0 * sh[:, 0]
    if deg > 0:
        r = r - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] \
            - SH_C1 * x * sh[:, 3]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        r = (r + SH_C2[0] * xy * sh[:, 4] + SH_C2[1] * yz * sh[:, 5]
             + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
             + SH_C2[3] * xz * sh[:, 7] + SH_C2[4] * (xx - yy) * sh[:, 8])
    if deg > 2:
        r = (r + SH_C3[0] * y * (3 * xx - yy) * sh[:, 9]
             + SH_C3[1] * xy * z * sh[:, 10]
             + SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 11]
             + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 12]
             + SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 13]
             + SH_C3[5] * z * (xx - yy) * sh[:, 14]
             + SH_C3[6] * x * (xx - 3 * yy) * sh[:, 15])
    return torch.clamp(r + 0.5, min=0.0)


def project(act: dict, cam: dict, sh_degree: int,
            cull_alpha: float = 1.0 / 255.0) -> dict:
    """Per-Gaussian screen state: xy, depth, conic (a, b, c), the tile
    rect [min, max) and `live`, and the colour."""
    dev = act["xyz"].device
    view = torch.as_tensor(cam["view"], device=dev)
    proj = torch.as_tensor(cam["proj"], device=dev)
    W, H = cam["width"], cam["height"]
    tfx, tfy = cam["tanfovx"], cam["tanfovy"]
    x = act["xyz"]
    ones = torch.ones_like(x[:, :1])
    xh = torch.cat([x, ones], 1)
    pv = (xh[:, :, None] * view[None]).sum(1)           # row vector @ view
    ph = (xh[:, :, None] * proj[None]).sum(1)
    tz = pv[:, 2]
    pw = 1.0 / (ph[:, 3] + 1e-7)
    ndc = ph[:, :2] * pw[:, None]
    xy = torch.stack([((ndc[:, 0] + 1.0) * W - 1.0) * 0.5,
                      ((ndc[:, 1] + 1.0) * H - 1.0) * 0.5], -1)
    fx, fy = W / (2.0 * tfx), H / (2.0 * tfy)
    tx = torch.clamp(pv[:, 0] / tz, -1.3 * tfx, 1.3 * tfx) * tz
    ty = torch.clamp(pv[:, 1] / tz, -1.3 * tfy, 1.3 * tfy) * tz
    # M = J Wr, J = [[fx/z, 0, -fx x/z^2], [0, fy/z, -fy y/z^2]], Wr the
    # world-to-view rotation (the transposed view matrix's block).
    Wr = view[:3, :3].T
    j0, j2 = fx / tz, -fx * tx / (tz * tz)
    k1, k2 = fy / tz, -fy * ty / (tz * tz)
    m0 = j0[:, None] * Wr[0][None] + j2[:, None] * Wr[2][None]
    m1 = k1[:, None] * Wr[1][None] + k2[:, None] * Wr[2][None]
    q = act["rot"]
    r, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = torch.stack([
        1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - r * qz),
        2 * (qx * qz + r * qy),
        2 * (qx * qy + r * qz), 1 - 2 * (qx * qx + qz * qz),
        2 * (qy * qz - r * qx),
        2 * (qx * qz - r * qy), 2 * (qy * qz + r * qx),
        1 - 2 * (qx * qx + qy * qy)], -1).reshape(-1, 3, 3)
    s2 = act["scales"] ** 2
    # u = m R (rows of the splat in the Gaussian's frame); cov = u S^2 u^T.
    u = (m0[:, :, None] * R).sum(1)
    v = (m1[:, :, None] * R).sum(1)
    a = (s2 * u * u).sum(1) + 0.3
    b = (s2 * u * v).sum(1)
    c = (s2 * v * v).sum(1) + 0.3
    det = a * c - b * b
    ok = det != 0.0
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    conic = torch.stack([c * inv, -b * inv, a * inv], -1)
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(
        mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))))
    op = act["op"]
    two_l = 2.0 * torch.log(torch.clamp(op, min=1e-12) / cull_alpha)
    ex = torch.minimum(radius, torch.ceil(torch.sqrt(
        torch.clamp(two_l * a, min=0.0))) + 1.0)
    ey = torch.minimum(radius, torch.ceil(torch.sqrt(
        torch.clamp(two_l * c, min=0.0))) + 1.0)
    gx, gy = -(-W // BLOCK), -(-H // BLOCK)

    def cell(vv, hi):
        return torch.clamp(torch.floor(vv / BLOCK), 0, hi).long()

    rmin = torch.stack([cell(xy[:, 0] - ex, gx), cell(xy[:, 1] - ey, gy)], -1)
    rmax = torch.stack([cell(xy[:, 0] + ex + BLOCK - 1, gx),
                        cell(xy[:, 1] + ey + BLOCK - 1, gy)], -1)
    area = (rmax - rmin).prod(-1)
    live = (tz > 0.2) & ok & (two_l > 0.0) & (radius > 0) & (area > 0)
    return dict(xy=xy, depth=tz, conic=conic, op=op, rmin=rmin, rmax=rmax,
                live=live, grid=(gx, gy),
                rgb=sh_color(act["shs"], x, torch.as_tensor(
                    cam["campos"], device=dev), sh_degree))


def entries(pr: dict) -> dict:
    """Every (tile, Gaussian) pair of the live rects, sorted by tile, then
    depth, then index: g [E] Gaussian ids, start / count [T] a tile."""
    gx, gy = pr["grid"]
    dev = pr["xy"].device
    key = torch.where(pr["live"], pr["depth"], torch.inf)
    order = torch.argsort(key, stable=True)
    order = order[pr["live"][order]]
    rmin, rmax = pr["rmin"][order], pr["rmax"][order]
    wid = rmax[:, 0] - rmin[:, 0]
    n = wid * (rmax[:, 1] - rmin[:, 1])
    g = torch.repeat_interleave(order, n)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    local = torch.arange(g.shape[0], device=dev) - first
    w_e = torch.repeat_interleave(wid, n)
    tile = ((torch.repeat_interleave(rmin[:, 1], n) + local // w_e) * gx
            + torch.repeat_interleave(rmin[:, 0], n) + local % w_e)
    srt = torch.argsort(tile, stable=True)
    count = torch.bincount(tile, minlength=gx * gy)
    return dict(g=g[srt], start=torch.cumsum(count, 0) - count, count=count)


def tile_groups(pr: dict, ent: dict, with_counts: bool = False):
    """Blocks of tiles, the fullest first, each padded to its longest
    list (tiles with no entry are left out): yields (tiles [B], gid
    [B, E], mask [B, E], w [B, 256, E] the blend weights, final T
    [B, 256], counts or None). counts: the
    evaluated pairs (each pixel's needed entries up to its end, the ending
    one included; an entry is needed when it reaches some pixel of its
    tile), the included pairs, the needed entries and the mask of
    Gaussians some needed entry names."""
    gx, _ = pr["grid"]
    dev = pr["xy"].device
    count, start = ent["count"], ent["start"]
    tiles_sorted = torch.argsort(count, descending=True, stable=True)
    counts_host = count[tiles_sorted].tolist()
    lp = torch.arange(P, device=dev)
    i = 0
    while i < len(counts_host) and counts_host[i] > 0:
        emax = counts_host[i]
        b = max(1, GROUP_ELEMENTS // (P * emax))
        tiles = tiles_sorted[i:i + b]
        i += b
        pos = torch.arange(emax, device=dev)
        mask = pos[None, :] < count[tiles][:, None]
        gid = ent["g"][torch.where(mask, start[tiles][:, None] + pos, 0)]
        xy = pr["xy"][gid]
        con = pr["conic"][gid]
        op = pr["op"][gid]
        px = ((tiles % gx) * BLOCK)[:, None] + (lp % BLOCK)[None, :]
        py = ((tiles // gx) * BLOCK)[:, None] + (lp // BLOCK)[None, :]
        dx = px.float()[:, :, None] - xy[:, None, :, 0]
        dy = py.float()[:, :, None] - xy[:, None, :, 1]
        power = (-0.5 * (con[:, None, :, 0] * dx * dx
                         + con[:, None, :, 2] * dy * dy)
                 - con[:, None, :, 1] * dx * dy)
        alpha = torch.clamp(op[:, None, :] * torch.exp(power), max=ALPHA_MAX)
        valid = mask[:, None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
        keep = torch.where(valid, 1.0 - alpha, 1.0)
        t_incl = torch.cumprod(keep, dim=2)
        t_excl = torch.cat([torch.ones_like(t_incl[:, :, :1]),
                            t_incl[:, :, :-1]], 2)
        test = t_excl * (1.0 - alpha)
        include = valid & (test >= T_EPS)
        w = torch.where(include, alpha * t_excl, 0.0)
        final_t = torch.where(include, 1.0 - alpha, 1.0).prod(2)
        counts = None
        if with_counts:
            ends = valid & (test < T_EPS)
            needed = valid.any(1)                             # [B, E]
            upto = torch.cumsum(needed.long(), 1)             # [B, E]
            end_pos = torch.where(ends.any(2), ends.float().argmax(2),
                                  emax - 1)                    # [B, 256]
            evaluated = torch.gather(upto, 1, end_pos)        # [B, 256]
            seen = torch.zeros(pr["xy"].shape[0], dtype=torch.bool,
                               device=dev)
            seen[gid[needed]] = True
            counts = dict(evaluated=int(evaluated.sum()),
                          included=int(include.sum()),
                          needed=int(needed.sum()), seen=seen)
        yield tiles, gid, mask, w, final_t, counts


def count_work(pr: dict, ent: dict) -> dict:
    """The blend's work on these inputs: evaluated and included pairs,
    needed entries and distinct Gaussians (see tile_groups)."""
    work = dict(evaluated=0, included=0, needed=0)
    seen = torch.zeros(pr["xy"].shape[0], dtype=torch.bool,
                       device=pr["xy"].device)
    for *_rest, counts in tile_groups(pr, ent, with_counts=True):
        for k in work:
            work[k] += counts[k]
        seen |= counts["seen"]
    work["distinct"] = int(seen.sum())
    return work


def blend(pr: dict, ent: dict, qw, qi, channels: int,
          prec: str = "f32") -> dict:
    """The quick blend: each Gaussian's (weight, index) pairs [N, S] summed
    into `channels` coefficient channels. Returns tile-layout maps: feat
    [T, 256, C], rgb [T, 256, 3], final_t [T, 256]."""
    gx, gy = pr["grid"]
    dev = pr["xy"].device
    T = gx * gy
    feat = torch.zeros((T, P, channels), device=dev)
    rgb = torch.zeros((T, P, 3), device=dev)
    final_t = torch.ones((T, P), device=dev)
    for tiles, gid, mask, w, ft, _counts in tile_groups(pr, ent):
        rows = torch.zeros(gid.shape + (channels,), device=dev)
        rows.scatter_add_(2, qi[gid].long(),
                          torch.where(mask[:, :, None], qw[gid], 0.0))
        feat[tiles] = matmul(w, rows, prec)
        rgb[tiles] = matmul(w, torch.where(mask[:, :, None], pr["rgb"][gid],
                                           0.0), prec)
        final_t[tiles] = ft
    return dict(feat=feat, rgb=rgb, final_t=final_t)


def blend_backward(pr: dict, ent: dict, qi, d_feat, prec: str = "f32"):
    """d(pair weights) [N, S] of the quick blend for d_feat [T, 256, C]:
    each entry's row of W^T d_feat read at its Gaussian's indices."""
    dev = pr["xy"].device
    dq = torch.zeros(qi.shape, device=dev)
    for tiles, gid, mask, w, _ft, _c in tile_groups(pr, ent):
        d_rows = matmul(w.transpose(1, 2), d_feat[tiles], prec)  # [B, E, C]
        d_pairs = torch.gather(d_rows, 2, qi[gid].long())        # [B, E, S]
        dq.index_add_(0, gid[mask], d_pairs[mask])
    return dq


def tiles_to_image(x: torch.Tensor, gx: int, gy: int, h: int, w: int):
    """[T, 256, C] in tile-pixel order -> [C, h, w]."""
    c = x.shape[-1]
    img = x.reshape(gy, gx, BLOCK, BLOCK, c).permute(4, 0, 2, 1, 3)
    return img.reshape(c, gy * BLOCK, gx * BLOCK)[:, :h, :w]


def image_to_tiles(img: torch.Tensor, gx: int, gy: int, fill=0):
    """[h, w] -> [T, 256] in tile-pixel order, `fill` past the image."""
    h, w = img.shape
    full = torch.full((gy * BLOCK, gx * BLOCK), fill, dtype=img.dtype,
                      device=img.device)
    full[:h, :w] = img
    return full.reshape(gy, BLOCK, gx, BLOCK).permute(0, 2, 1, 3).reshape(
        gx * gy, P)
