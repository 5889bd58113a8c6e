"""Tile blend (kernel K2), modes "rgb" and "quick" with f32 numerics
(port of langsplatv2_tpu/ops/pallas_blend.py, `blend_tiles_pallas` with
rowfmt="f32").

On a CUDA tensor `blend_tiles` launches csrc/blend.cu; on a CPU tensor it
runs `blend_tiles_plain`, a per-position loop vectorized over tiles and
pixels with the kernel's exact sequence of f32 ops (the oracle of the GPU
checks). The kernel is bound by its output bytes (the [T, 256, 196] f32
tiles) and the per-pair f32 work; csrc/blend.cu says how its design meets
that. The Pallas kernel's packed rows (index pairs as lo + 256*hi in
f32, 128-aligned field-major windows) are TPU devices the port does not
need: both versions gather per-Gaussian state by g_sorted.
"""
from __future__ import annotations

import torch

from . import kernels
from .projection import BLOCK

P = BLOCK * BLOCK
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def pack_gaussian_state(xy, conic, opacities, colors) -> torch.Tensor:
    """[N, 9] f32 rows: x y conic(3) opacity r g b (zeros without colors)."""
    n = xy.shape[0]
    rgb = colors if colors is not None else torch.zeros(
        (n, 3), dtype=xy.dtype, device=xy.device)
    return torch.cat([xy, conic, opacities[:, None], rgb], dim=1).contiguous()


def replay_positions(g_sorted, tile_start, tile_count, geom, grid_x):
    """The blend's per-position loop, vectorized over tiles and pixels: for
    each depth position j of the tiles' segments yields (j, live [T] bool,
    g [T] Gaussian ids, row [T, 9] state, w [T, 256] blend weights, T
    [T, 256] transmittance after position j), with K2's exact f32 op
    sequence. Stops once every pixel has ended (checked every 32
    positions); later weights would all be 0."""
    dev = geom.device
    n_tiles = tile_start.shape[0]
    tid = torch.arange(n_tiles, device=dev)
    pix = torch.arange(P, device=dev)
    px = ((tid % grid_x)[:, None] * BLOCK + pix % BLOCK).float()
    py = ((tid // grid_x)[:, None] * BLOCK + pix // BLOCK).float()
    T = torch.ones((n_tiles, P), device=dev)
    done = torch.zeros((n_tiles, P), dtype=torch.bool, device=dev)
    n_max = int(tile_count.max()) if n_tiles else 0
    for j in range(n_max):
        if j % 32 == 0 and bool(done.all()):
            break
        live = j < tile_count
        g = g_sorted[torch.where(live, tile_start + j, 0)].long()
        row = geom[g]
        dx = px - row[:, 0:1]
        dy = py - row[:, 1:2]
        ca, cb, cc, op = row[:, 2:3], row[:, 3:4], row[:, 4:5], row[:, 5:6]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
        valid = (live[:, None] & ~done & (power <= 0.0)
                 & (alpha >= ALPHA_MIN))
        test_t = T * (1.0 - alpha)
        ends = valid & (test_t < T_EPS)
        done |= ends
        inc = valid & ~ends
        w = torch.where(inc, alpha * T, 0.0)
        T = torch.where(inc, test_t, T)
        yield j, live, g, row, w, T


def blend_tiles_plain(g_sorted, tile_start, tile_count, geom, bg, grid_x,
                      quick_weights=None, quick_indices=None, channels=0):
    dev = geom.device
    n_tiles = tile_start.shape[0]
    T = torch.ones((n_tiles, P), device=dev)
    acc = torch.zeros((n_tiles, P, 3), device=dev)
    feat = (torch.zeros((n_tiles, P, channels), device=dev)
            if channels else None)
    topk = quick_weights.shape[1] if channels else 0
    for _j, _live, g, row, w, T in replay_positions(
            g_sorted, tile_start, tile_count, geom, grid_x):
        acc += w[..., None] * row[:, None, 6:9]
        for k in range(topk):
            src = w * quick_weights[g, k][:, None]
            idx = quick_indices[g, k].long()[:, None, None].expand(-1, P, 1)
            feat.scatter_add_(2, idx, src[..., None])
    rgb = acc + T[..., None] * bg
    return rgb, feat, T


def blend_tiles(g_sorted, tile_start, tile_count, geom, bg, grid_x: int,
                grid_y: int, quick_weights=None, quick_indices=None,
                channels: int = 0, stats=None):
    """Blend every tile of the grid. Returns (rgb [T, 256, 3], feat
    [T, 256, channels] or None, final_T [T, 256]); T = grid_x * grid_y.

    g_sorted [E] i32, tile_start/tile_count [T] i32, geom [N, 9] f32
    (pack_gaussian_state), bg [3] f32; quick mode: quick_weights [N, S]
    f32, quick_indices [N, S] i32 in [0, channels). The feature map has no
    background term. On CUDA the channel accumulators share one block's
    shared memory; more channels than fit (209 at S=12) make the
    launch raise with the kernel's CUDA error. `stats` (CUDA only): an int64 [2] tensor that gets
    the count of evaluated and of included (entry, pixel) pairs added."""
    dev = geom.device
    n_tiles = grid_x * grid_y
    quick = channels > 0
    if dev.type == "cpu":
        return blend_tiles_plain(g_sorted, tile_start, tile_count, geom, bg,
                                 grid_x, quick_weights, quick_indices,
                                 channels)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles: unsupported device {dev}")
    n = geom.shape[0]
    kernels.check_tensor(g_sorted, "g_sorted", torch.int32, (None,), dev)
    kernels.check_tensor(tile_start, "tile_start", torch.int32, (n_tiles,),
                         dev)
    kernels.check_tensor(tile_count, "tile_count", torch.int32, (n_tiles,),
                         dev)
    kernels.check_tensor(geom, "geom", torch.float32, (n, 9), dev)
    kernels.check_tensor(bg, "bg", torch.float32, (3,), dev)
    topk = 0
    if quick:
        topk = quick_weights.shape[1]
        kernels.check_tensor(quick_weights, "quick_weights", torch.float32,
                             (n, topk), dev)
        kernels.check_tensor(quick_indices, "quick_indices", torch.int32,
                             (n, topk), dev)
    if stats is not None:
        kernels.check_tensor(stats, "stats", torch.int64, (2,), dev)
    rgb = torch.empty((n_tiles, P, 3), device=dev)
    feat = torch.empty((n_tiles, P, channels), device=dev) if quick else None
    final_t = torch.empty((n_tiles, P), device=dev)
    P_ = kernels.ptr
    null = kernels.NULL
    kernels.launch(
        "lsv2_blend_tiles", P_(g_sorted), P_(tile_start), P_(tile_count),
        P_(geom), P_(quick_weights) if quick else null,
        P_(quick_indices) if quick else null, P_(bg), n_tiles, grid_x, topk,
        channels, P_(rgb), P_(feat) if quick else null, P_(final_t),
        P_(stats) if stats is not None else null, kernels.stream(rgb))
    blend_tiles.launches += 1
    return rgb, feat, final_t


blend_tiles.launches = 0
