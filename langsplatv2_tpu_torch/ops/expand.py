"""Tile binning: entry expansion (kernel K1), sort keys, tile ranges
(port of langsplatv2_tpu/ops/pallas_binning.py:354-630).

`expand_entries` replaces `expand_entries_pallas` (the TPU kernel
`_expand_kernel`). On a CUDA tensor it launches csrc/expand.cu; on a CPU
tensor it runs `expand_entries_plain`, which the GPU checks also use as
the oracle. The kernel is bound by bytes on the card (each Gaussian's
state read once, 12 B written a slot); csrc/expand.cu says how its
design meets that. On CUDA the wrapper is the scan (`torch.cumsum`) and
one launch: the kernel writes every slot and `total`. `with_alpha=s` is
the `subdiv` branch of `_expand_one_chunk` (:327-348): each entry also
gets log1p(-alpha_max) over each of the s x s sub-boxes of its tile, the
bound of the round-4 budget chain (ops/budget.py::pack_lm_words
onwards). `sort_entries`
replaces `pack_sort_keys` + `sorted_binning_from_keys`: those were
`lax.sort`, not Pallas, so the library sort is the port's sort too.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from . import kernels
from .projection import BLOCK, ProjectedGaussians


def _box_qmin(ca, cb, cc, lx, hx, ly, hy):
    """Min of q = ca u^2 + 2 cb u v + cc v^2 over the box [lx, hx] x
    [ly, hy] (mean-relative pixels): 0 inside, else the least of the four
    edges' closed-form minima (pallas_binning.py:300-322)."""
    def q(u, v):
        return ca * u * u + 2.0 * cb * u * v + cc * v * v

    def edge_u(ufix):
        return q(ufix, torch.clamp(-cb * ufix / cc, min=ly, max=hy))

    def edge_v(vfix):
        return q(torch.clamp(-cb * vfix / ca, min=lx, max=hx), vfix)

    inside = (lx <= 0.0) & (0.0 <= hx) & (ly <= 0.0) & (0.0 <= hy)
    q_min = torch.minimum(torch.minimum(edge_u(lx), edge_u(hx)),
                          torch.minimum(edge_v(ly), edge_v(hy)))
    return torch.where(inside, 0.0, q_min)


def _cull_mask(tile_x, tile_y, cx, cy, conic_a, conic_b, conic_c, op,
               inv_cull_alpha: float):
    """Exact conic-vs-tile cull: keep an entry iff the Gaussian's maximum
    alpha over the tile's pixel box reaches cull_alpha. Op for op in the
    order of the Pallas kernel (pallas_binning.py:292-322)."""
    ca = torch.clamp(conic_a, min=1e-12)
    cc = torch.clamp(conic_c, min=1e-12)
    lx = tile_x.float() * float(BLOCK) - cx
    ly = tile_y.float() * float(BLOCK) - cy
    q_min = _box_qmin(ca, conic_b, cc, lx, lx + float(BLOCK - 1), ly,
                      ly + float(BLOCK - 1))
    thresh = 2.0 * torch.log(torch.clamp(op, min=1e-12) * inv_cull_alpha) + 1e-4
    return q_min <= thresh


def _sub_box_lm(tile_x, tile_y, cx, cy, conic_a, conic_b, conic_c, op,
                owned, subdiv: int):
    """lm [subdiv^2, n] (sub-box row-major): each owned entry's
    log1p(-min(alpha_max, 0.99)) over each sub-box of its tile, 0 for the
    others (pallas_binning.py:327-348, op for op)."""
    ca = torch.clamp(conic_a, min=1e-12)
    cc = torch.clamp(conic_c, min=1e-12)
    lx = tile_x.float() * float(BLOCK) - cx
    ly = tile_y.float() * float(BLOCK) - cy
    side = BLOCK // subdiv
    op_c = torch.clamp(op, max=1.0)
    lms = []
    for i in range(subdiv * subdiv):
        sy, sx = divmod(i, subdiv)
        # (tile * 16 - c) + offset: JAX's order here, which rounds
        # differently from budget_from_rows' tile * 16 + offset - c.
        blx = lx + float(sx * side)
        bly = ly + float(sy * side)
        qm = _box_qmin(ca, conic_b, cc, blx, blx + float(side - 1), bly,
                       bly + float(side - 1))
        am = torch.clamp(op_c * torch.exp(-0.5 * torch.clamp(qm, min=0.0)),
                         max=0.99)
        lms.append(torch.where(owned, torch.log1p(-am), 0.0))
    return torch.stack(lms)


def expand_entries_plain(proj: ProjectedGaussians, opacities, offsets,
                         grid_x: int, grid_y: int, max_entries: int,
                         exact_cull: bool, inv_cull_alpha: float,
                         with_alpha: int = 0):
    """repeat_interleave expansion + the vectorized cull; same outputs as
    the kernel: (tile, depth, gauss), and lm [with_alpha^2, E] when
    with_alpha > 0."""
    dev = proj.xy.device
    sentinel = grid_x * grid_y
    tiles = proj.tiles_touched.long()
    n_live = min(int(tiles.sum()), max_entries)
    gid = torch.repeat_interleave(
        torch.arange(tiles.shape[0], device=dev), tiles)[:n_live]
    slot = torch.arange(n_live, device=dev) - offsets[gid]
    rect_w = torch.clamp(proj.rect_max[gid, 0] - proj.rect_min[gid, 0], min=1)
    ty = torch.div(slot, rect_w, rounding_mode="floor")
    tile_x = proj.rect_min[gid, 0] + (slot - ty * rect_w)
    tile_y = proj.rect_min[gid, 1] + ty
    owned = torch.ones(n_live, dtype=torch.bool, device=dev)
    state = (proj.xy[gid, 0], proj.xy[gid, 1], proj.conic[gid, 0],
             proj.conic[gid, 1], proj.conic[gid, 2], opacities[gid])
    if exact_cull:
        owned = _cull_mask(tile_x, tile_y, *state, inv_cull_alpha)
    tile = torch.full((max_entries,), sentinel, dtype=torch.int32, device=dev)
    depth = torch.zeros(max_entries, dtype=torch.float32, device=dev)
    gauss = torch.zeros(max_entries, dtype=torch.int32, device=dev)
    tile[:n_live] = torch.where(owned, tile_y * grid_x + tile_x, sentinel).int()
    depth[:n_live] = torch.where(owned, proj.depth[gid], 0.0)
    gauss[:n_live] = torch.where(owned, gid, 0).int()
    if not with_alpha:
        return tile, depth, gauss
    lm = torch.zeros((with_alpha * with_alpha, max_entries),
                     dtype=torch.float32, device=dev)
    lm[:, :n_live] = _sub_box_lm(tile_x, tile_y, *state, owned, with_alpha)
    return tile, depth, gauss, lm


def expand_entries(proj: ProjectedGaussians, opacities: torch.Tensor,
                   grid_x: int, grid_y: int, max_entries: int, *,
                   exact_cull: bool = True,
                   cull_alpha: float = 1.0 / 255.0, with_alpha: int = 0):
    """Per-entry (tile [E] i32 — sentinel grid_x*grid_y when dead, depth
    [E] f32, gauss [E] i32) at gaussian-major offsets, E = max_entries,
    plus total [] i32 = min(sum(tiles_touched), max_entries). With
    with_alpha = s > 0 (needs exact_cull; s divides 16) a fifth output,
    lm [s^2, E] f32, sub-box-major: each kept entry's log1p(-alpha_max)
    over each of the s x s sub-boxes of its tile (row-major), 0 for a
    culled entry or one at or past total. The counters (tracing.py)
    "k1.launches" count every launch of K1, "k1.alpha_launches" those with
    with_alpha > 0, "k1.nocull_launches" those without the exact cull (the
    XLA route's binning)."""
    if with_alpha:
        if not exact_cull:
            raise ValueError("with_alpha requires exact_cull")
        if with_alpha not in (1, 2, 4, 8, 16):
            raise ValueError(f"with_alpha must divide {BLOCK}, not "
                             f"{with_alpha}")
    dev = proj.xy.device
    n = proj.xy.shape[0]
    tiles = proj.tiles_touched
    ends = torch.cumsum(tiles, 0, dtype=torch.int64)
    # JAX multiplies by a Python float cast to f32: keep that constant.
    inv_cull_alpha = float(np.float32(1.0 / cull_alpha))
    if dev.type == "cpu":
        total = torch.clamp(tiles.sum(dtype=torch.int64),
                            max=max_entries).int()
        out = expand_entries_plain(proj, opacities, ends - tiles, grid_x,
                                   grid_y, max_entries, exact_cull,
                                   inv_cull_alpha, with_alpha)
        return (*out[:3], total, *out[3:])
    if dev.type != "cuda":
        raise ValueError(f"expand_entries: unsupported device {dev}")
    for name, t, dtype, shape in (
            ("xy", proj.xy, torch.float32, (n, 2)),
            ("depth", proj.depth, torch.float32, (n,)),
            ("conic", proj.conic, torch.float32, (n, 3)),
            ("opacities", opacities, torch.float32, (n,)),
            ("rect_min", proj.rect_min, torch.int32, (n, 2)),
            ("rect_max", proj.rect_max, torch.int32, (n, 2)),
            ("tiles_touched", tiles, torch.int32, (n,))):
        kernels.check_tensor(t, name, dtype, shape, dev)
    # The kernel writes every slot, dead ones included, and total.
    tile = torch.empty(max_entries, dtype=torch.int32, device=dev)
    depth = torch.empty(max_entries, dtype=torch.float32, device=dev)
    gauss = torch.empty(max_entries, dtype=torch.int32, device=dev)
    total = torch.empty((), dtype=torch.int32, device=dev)
    lm = torch.empty((with_alpha * with_alpha, max_entries),
                     dtype=torch.float32, device=dev) if with_alpha else None
    P = kernels.ptr
    kernels.launch(
        "lsv2_expand_entries", P(proj.xy), P(proj.depth), P(proj.conic),
        P(opacities), P(proj.rect_min), P(proj.rect_max), P(tiles),
        P(ends), n, grid_x, max_entries, grid_x * grid_y, int(exact_cull),
        inv_cull_alpha, P(tile), P(depth), P(gauss), with_alpha,
        P(lm) if with_alpha else kernels.NULL, P(total),
        kernels.stream(tile))
    tracing.count("k1.launches")
    if not exact_cull:
        tracing.count("k1.nocull_launches")
    if not with_alpha:
        return tile, depth, gauss, total
    tracing.count("k1.alpha_launches")
    return tile, depth, gauss, total, lm


def sort_entries(tile, depth, gauss, num_tiles: int, payload=()):
    """Stable sort of the gaussian-major entries by the int64 key
    tile << 31 | depth bits: the (tile, depth, gauss id) order of the JAX
    packed-key sort, dead entries (sentinel tile) last. Returns
    (g_sorted [E] i32, tile_start [T] i32, tile_count [T] i32) and, when
    `payload` (a sequence of [E] arrays, e.g. pack_lm_words' words) is
    not empty, a fourth output: the payloads in sorted order (JAX's extra
    sort operands, sorted_binning_from_keys(extra=...))."""
    depth_bits = depth.view(torch.int32).long() & 0x7FFFFFFF
    key = (tile.long() << 31) | depth_bits
    key_sorted, perm = torch.sort(key, stable=True)
    g_sorted = gauss[perm]
    tile_sorted = (key_sorted >> 31).int()
    bounds = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, dtype=torch.int32,
                                  device=tile.device))
    out = (g_sorted, bounds[:-1].int(), (bounds[1:] - bounds[:-1]).int())
    if len(payload):
        out = out + (tuple(p[perm] for p in payload),)
    return out
