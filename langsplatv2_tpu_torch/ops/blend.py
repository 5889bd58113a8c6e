"""Tile blend (kernel K2), modes "rgb" and "quick" on f32 state, and the
quick mode on fast16 rows (port of langsplatv2_tpu/ops/pallas_blend.py,
`blend_tiles_pallas` with rowfmt="f32" and "fast16", and
`pack_fast16_rows` / `_unpack_hi` / `_unpack_lo`).

On a CUDA tensor `blend_tiles` launches csrc/blend.cu; on a CPU tensor it
runs `blend_tiles_plain`, a per-position loop vectorized over tiles and
pixels with the kernel's exact sequence of f32 ops (the oracle of the GPU
checks). The kernel is bound by its output bytes (the [T, 256, 196] f32
tiles) and the per-pair f32 work; csrc/blend.cu says how its design meets
that. The Pallas kernel's packed rows (index pairs as lo + 256*hi in
f32, 128-aligned field-major windows) are TPU devices the port does not
need: both versions gather per-Gaussian state by g_sorted.

fast16 (precision="bf16", the serving default): what must match JAX is the
numerics, not the layout. xy stays f32; conic, opacity, rgb and the top-k
weights are rounded to bf16 (round to nearest even, as JAX's astype);
indices are exact. The port's row is 64 bytes a Gaussian
(`pack_fast16_rows`), against the 16-wide f32 row of base-256 triples and
bf16 pairs that the TPU gathers. `blend_tiles_fast16` launches the kernel's
fast16 mode on CUDA tensors; `blend_tiles_fast16_plain` is the f32 blend on
the unpacked (rounded) state followed by the same output rounding.

Fused query (K2q, `blend_tiles_query`, port of `blend_tiles_query` with
its epilogue :483-501): the fast16 blend with f32 outputs and, per pixel,
the Gram query of kernel K3 from the channel accumulators, so the
[T, 256, L*K] map is never written. The products take the weights, phi
and gram rounded to bf16 (the TPU kernel's MXU pass); the last factor of
nrm2 and its band sum use the f32 accumulator. `blend_tiles_query_plain`
is the fast16 plain blend followed by those products in torch. It takes
every L, K and PQ with L*K <= 256 (fast16's u8 indices):
`query.kernel_plan(L, K, PQ, bf16=True)` says which epilogue runs; past
192 channels a tile takes a cluster of two blocks (csrc/blend.cu).

Level bands (`banded`, JAX's banded=True, pallas_blend.py:386-401): in the
fast16 and query modes slot k of a row belongs to level k // (topk / L),
L = channels / 64, and its pair is dropped unless its index lies in
[64 l, 64 l + 64). The wrappers apply it where JAX's callers do
(`level_banded`: channels % 64 == 0 and topk a multiple of channels / 64);
`banded=False` turns it off, for comparisons with JAX's unbanded kernel.
The f32 quick mode is never banded, as JAX's f32 path is not.

bf16 cells (`cells_bf16`, JAX's bf16_cells, pallas_blend.py:282-299,
:323-336, :373-385): the fast16 and query modes' alpha, transmittance and
blend weight rounded to bf16 (csrc/blend.cu lists the rounding points);
the plain versions round at the same points with torch's bf16 arithmetic.

Dense mode (`blend_tiles_dense`, K2's mode="dense", pallas_blend.py
:342-346): the f32 blend of each entry's own feature row F[g] (F [N, D]
f32) into [T, 256, D], in channel groups of at most 192 a launch.

Pair counts (`pair_counts_plain`): the (evaluated, included) pairs that
each mode's `stats` counts, from `replay_positions`; they are integers,
so the kernel's must equal them. The kernel walks a segment in batches of
BATCH entries (DENSE_BATCH in dense mode, NARROW_BATCH in dense launches
of at most NARROW_DENSE columns, RGB_BATCH without channels), the numbers
the card tests place segment and termination boundaries around.
"""
from __future__ import annotations

import torch

from . import kernels
from .projection import BLOCK
from .query import kernel_plan, round_bf16

P = BLOCK * BLOCK
FAST16_PAIRS = 12      # (index, weight) slots of a fast16 row
LEVEL_BAND = 64        # codebook rows a level band
DENSE_GROUP = 192      # dense mode: channels a launch (shared accumulators)
BATCH = 24             # csrc/blend.cu kQuickBatch: entries a batch
DENSE_BATCH = 8        # csrc/blend.cu kDenseBatch
NARROW_BATCH = 32      # csrc/blend.cu kNarrowBatch
NARROW_DENSE = 64      # csrc/blend.cu kNarrowDense
RGB_BATCH = 96         # csrc/blend.cu kRgbBatch
F32_MAX_PAIRS = 27     # f32 quick mode: a batch's raw words fit 2 a thread
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def pack_gaussian_state(xy, conic, opacities, colors) -> torch.Tensor:
    """[N, 9] f32 rows: x y conic(3) opacity r g b (zeros without colors)."""
    n = xy.shape[0]
    rgb = colors if colors is not None else torch.zeros(
        (n, 3), dtype=xy.dtype, device=xy.device)
    return torch.cat([xy, conic, opacities[:, None], rgb], dim=1).contiguous()


def _bf16(x):
    return x.to(torch.bfloat16)


def level_banded(channels: int, topk: int) -> bool:
    """JAX's condition for the level-banded expansion
    (ops/rasterize.py:433-434, 641-642; ops/temporal.py:210-211)."""
    return channels % LEVEL_BAND == 0 and topk % (channels // LEVEL_BAND) == 0


def _per_level(banded: bool, channels: int, topk: int) -> int:
    """Slots a level band for the kernel: JAX's rule where `level_banded`
    holds, unless `banded` is False; 0 for no bands."""
    if not (banded and level_banded(channels, topk)):
        return 0
    return topk // (channels // LEVEL_BAND)


def fast16_pose_words(xy, conic, opacities) -> torch.Tensor:
    """Words 0-3 of a fast16 row, the fields a new pose changes: x y (f32),
    then ca cb cc opacity as bf16 halves. [N, 4] int32."""
    halves = _bf16(torch.cat([conic, opacities[:, None]], dim=1))
    return torch.cat([xy.float().contiguous().view(torch.uint8),
                      halves.view(torch.uint8)], dim=1).view(torch.int32)


def pack_fast16_rows(xy, conic, opacities, colors, quick_weights,
                     quick_indices) -> torch.Tensor:
    """[N, 16] int32 words, 64 bytes a Gaussian: x y (f32), then as bf16
    ca cb cc opacity r g b 0, then 12 u8 codebook indices, 12 bf16 weights
    and 4 zero bytes. Top-k widths under 12 are padded with zero weights;
    indices must lie in [0, 256)."""
    n, s = quick_weights.shape
    if s > FAST16_PAIRS:
        raise ValueError(f"fast16 rows hold {FAST16_PAIRS} pairs, not {s}")
    dev = xy.device
    rgb = colors if colors is not None else torch.zeros((n, 3), device=dev)
    pad = FAST16_PAIRS - s
    color = _bf16(torch.cat([rgb, torch.zeros((n, 1), device=dev)], dim=1))
    idx = torch.nn.functional.pad(quick_indices.to(torch.uint8), (0, pad))
    w = _bf16(torch.nn.functional.pad(quick_weights, (0, pad)))
    row = torch.cat([fast16_pose_words(xy, conic, opacities).view(
                         torch.uint8), color.view(torch.uint8), idx,
                     w.view(torch.uint8),
                     torch.zeros((n, 4), dtype=torch.uint8, device=dev)],
                    dim=1)
    return row.view(torch.int32)


def unpack_fast16_rows(rows, topk: int):
    """Inverse of pack_fast16_rows: (geom [N, 9] f32 as
    pack_gaussian_state lays it out, weights [N, topk] f32, indices
    [N, topk] i32), the bf16 halves widened exactly."""
    b = rows.view(torch.uint8)
    halves = b[:, 8:24].contiguous().view(torch.bfloat16).float()
    geom = torch.cat([b[:, 0:8].contiguous().view(torch.float32),
                      halves[:, :7]], dim=1)
    qi = b[:, 24:24 + topk].int()
    qw = b[:, 36:60].contiguous().view(torch.bfloat16).float()[:, :topk]
    return geom, qw.contiguous(), qi.contiguous()


def pixel_coords(n_tiles: int, grid_x: int, device):
    """(px, py) [T, 256] f32: each tile pixel's coordinates, row-major."""
    tid = torch.arange(n_tiles, device=device)
    pix = torch.arange(P, device=device)
    px = ((tid % grid_x)[:, None] * BLOCK + pix % BLOCK).float()
    py = ((tid // grid_x)[:, None] * BLOCK + pix // BLOCK).float()
    return px, py


def replay_positions(g_sorted, tile_start, tile_count, geom, grid_x,
                     cells_bf16: bool = False, evaluated=None):
    """The blend's per-position loop, vectorized over tiles and pixels: for
    each depth position j of the tiles' segments yields (j, live [T] bool,
    g [T] Gaussian ids, row [T, 9] state, w [T, 256] blend weights, T
    [T, 256] transmittance after position j), with K2's exact f32 op
    sequence, or with `cells_bf16` its bf16 cell math (the transmittance
    exp(S), S the f32 sum of the included pairs' bf16 log1p(-alpha)). Stops
    once every pixel has ended (checked every 32 positions); later weights
    would all be 0. `evaluated` (int64 [T, 256]), if given, gets 1 added
    for each position a pixel reaches, its terminating one included."""
    dev = geom.device
    n_tiles = tile_start.shape[0]
    px, py = pixel_coords(n_tiles, grid_x, dev)
    T = torch.ones((n_tiles, P), device=dev)
    S = torch.zeros((n_tiles, P), device=dev)
    done = torch.zeros((n_tiles, P), dtype=torch.bool, device=dev)
    alpha_max_b = torch.full((), ALPHA_MAX, dtype=torch.bfloat16, device=dev)
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
        if cells_bf16:
            ab = torch.minimum(_bf16(op) * torch.exp(_bf16(power)),
                               alpha_max_b)
            tb = torch.exp(_bf16(S))
            alpha, test_t = ab.float(), (tb * (1.0 - ab)).float()
            wb = (ab * tb).float()
            lm = _bf16(torch.log1p(-alpha)).float()
        else:
            alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
            test_t = T * (1.0 - alpha)
            wb = alpha * T
        valid = (live[:, None] & ~done & (power <= 0.0)
                 & (alpha >= ALPHA_MIN))
        ends = valid & (test_t < T_EPS)
        if evaluated is not None:
            evaluated += live[:, None] & ~done
        done |= ends
        inc = valid & ~ends
        w = torch.where(inc, wb, 0.0)
        if cells_bf16:
            S = torch.where(inc, S + lm, S)
            T = torch.exp(S)
        else:
            T = torch.where(inc, test_t, T)
        yield j, live, g, row, w, T


def pair_counts_plain(g_sorted, tile_start, tile_count, geom, grid_x,
                      cells_bf16: bool = False) -> tuple[int, int]:
    """(evaluated, included) (entry, pixel) pairs as K2's `stats` counts
    them: a pixel evaluates each entry of its tile's segment up to and
    including the one that ends it (all of them if none does), whether
    its pair is skipped or not; it includes those whose blend weight is
    added. geom [N, 9] (`unpack_fast16_rows` for fast16 rows)."""
    n_tiles = tile_start.shape[0]
    evaluated = torch.zeros((n_tiles, P), dtype=torch.int64,
                            device=geom.device)
    included = torch.zeros((), dtype=torch.int64, device=geom.device)
    for _j, _live, _g, _row, w, _T in replay_positions(
            g_sorted, tile_start, tile_count, geom, grid_x, cells_bf16,
            evaluated):
        included += (w > 0).sum()
    return int(evaluated.sum()), int(included)


def kernel_occupancy(mode: str, channels: int, topk: int) -> dict:
    """K2's instantiation `mode` ("f32", "fast16", "fast16 cells", "query",
    "query cells", "dense", "rgb": the f32 blend without channels, "dense
    narrow": dense launches of at most 64 columns, "query any" and "query
    pair" (+ " cells"): the fused query at other shapes, one block or two a
    tile) at this width (CUDA only): resident blocks and warps an SM,
    dynamic shared bytes, registers and local (spill, stack) bytes a
    thread, from the CUDA runtime."""
    code = {"f32": (0, 0), "fast16": (1, 0), "fast16 cells": (1, 1),
            "query": (2, 0), "query cells": (2, 1), "dense": (3, 0),
            "rgb": (4, 0), "dense narrow": (5, 0), "query any": (6, 0),
            "query any cells": (6, 1), "query pair": (7, 0),
            "query pair cells": (7, 1)}[mode]
    return kernels.occupancy("lsv2_blend_occupancy", *code, channels, topk)


def blend_tiles_plain(g_sorted, tile_start, tile_count, geom, bg, grid_x,
                      quick_weights=None, quick_indices=None, channels=0,
                      per_level: int = 0, cells_bf16: bool = False):
    """`per_level` > 0: the level-band rule (a pair outside its slot's
    band goes to a dropped extra channel); `cells_bf16`: the bf16 cells."""
    dev = geom.device
    n_tiles = tile_start.shape[0]
    T = torch.ones((n_tiles, P), device=dev)
    acc = torch.zeros((n_tiles, P, 3), device=dev)
    feat = (torch.zeros((n_tiles, P, channels + (per_level > 0)), device=dev)
            if channels else None)
    topk = quick_weights.shape[1] if channels else 0
    for _j, _live, g, row, w, T in replay_positions(
            g_sorted, tile_start, tile_count, geom, grid_x, cells_bf16):
        acc += w[..., None] * row[:, None, 6:9]
        for k in range(topk):
            src = w * quick_weights[g, k][:, None]
            idx = quick_indices[g, k].long()
            if per_level:
                lo = (k // per_level) * LEVEL_BAND
                idx = torch.where((idx >= lo) & (idx < lo + LEVEL_BAND), idx,
                                  channels)
            idx = idx[:, None, None].expand(-1, P, 1)
            feat.scatter_add_(2, idx, src[..., None])
    if per_level and channels:
        feat = feat[..., :channels].contiguous()
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
    shared memory; more channels than fit (194 at S = 12) make the launch
    raise with the kernel's CUDA error, and S is at most F32_MAX_PAIRS.
    `stats` (CUDA only): an int64 [2] tensor that gets the count of
    evaluated and of included (entry, pixel) pairs added
    (`pair_counts_plain`)."""
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
        if topk > F32_MAX_PAIRS:
            raise ValueError(f"the f32 quick blend takes at most "
                             f"{F32_MAX_PAIRS} pairs a Gaussian, not {topk}")
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


def blend_tiles_fast16_plain(g_sorted, tile_start, tile_count, rows, bg,
                             grid_x, topk: int, channels: int,
                             feat_bf16: bool, banded: bool = True,
                             cells_bf16: bool = False):
    """The f32 blend (or its bf16 cells) on the unpacked state with bg =
    0, then the outputs: with feat_bf16 the feature tiles and the
    background-free colour rounded to bf16, then rgb = colour + T * bg."""
    geom, qw, qi = unpack_fast16_rows(rows, topk)
    acc, feat, T = blend_tiles_plain(
        g_sorted, tile_start, tile_count, geom, torch.zeros_like(bg), grid_x,
        qw, qi, channels, _per_level(banded, channels, topk), cells_bf16)
    if feat_bf16:
        acc, feat = _bf16(acc).float(), _bf16(feat)
    return acc + T[..., None] * bg, feat, T


def blend_tiles_fast16(g_sorted, tile_start, tile_count, rows, bg,
                       grid_x: int, grid_y: int, topk: int, channels: int,
                       feat_bf16: bool = True, stats=None, *,
                       banded: bool = True, cells_bf16: bool = False):
    """The quick blend on fast16 rows [N, 16] (pack_fast16_rows). Returns
    (rgb [T, 256, 3] f32, feat [T, 256, channels] bf16 when feat_bf16 else
    f32, final_T [T, 256] f32). Other inputs as for `blend_tiles`;
    channels <= 256 (u8 indices). `banded`: the level-band rule where
    `level_banded` holds (False: none, as JAX's unbanded kernel);
    `cells_bf16`: the bf16 cell math."""
    dev = rows.device
    n_tiles = grid_x * grid_y
    if not 0 < channels <= 256:
        raise ValueError(f"fast16 rows index at most 256 channels, not "
                         f"{channels}")
    per_level = _per_level(banded, channels, topk)
    if dev.type == "cpu":
        return blend_tiles_fast16_plain(g_sorted, tile_start, tile_count,
                                        rows, bg, grid_x, topk, channels,
                                        feat_bf16, banded, cells_bf16)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles_fast16: unsupported device {dev}")
    kernels.check_tensor(g_sorted, "g_sorted", torch.int32, (None,), dev)
    kernels.check_tensor(tile_start, "tile_start", torch.int32, (n_tiles,),
                         dev)
    kernels.check_tensor(tile_count, "tile_count", torch.int32, (n_tiles,),
                         dev)
    kernels.check_tensor(rows, "rows", torch.int32, (None, 16), dev)
    kernels.check_tensor(bg, "bg", torch.float32, (3,), dev)
    if rows.data_ptr() % 16:
        raise ValueError("rows: not 16-byte aligned")
    if not 0 < topk <= FAST16_PAIRS:
        raise ValueError(f"topk {topk} outside [1, {FAST16_PAIRS}]")
    if stats is not None:
        kernels.check_tensor(stats, "stats", torch.int64, (2,), dev)
    rgb = torch.empty((n_tiles, P, 3), device=dev)
    feat = torch.empty((n_tiles, P, channels), device=dev,
                       dtype=torch.bfloat16 if feat_bf16 else torch.float32)
    final_t = torch.empty((n_tiles, P), device=dev)
    P_ = kernels.ptr
    kernels.launch(
        "lsv2_blend_tiles_fast16", P_(g_sorted), P_(tile_start),
        P_(tile_count), P_(rows), P_(bg), n_tiles, grid_x, topk, channels,
        int(feat_bf16), per_level, int(cells_bf16), P_(rgb), P_(feat),
        P_(final_t),
        P_(stats) if stats is not None else kernels.NULL,
        kernels.stream(rgb))
    blend_tiles_fast16.launches += 1
    return rgb, feat, final_t


blend_tiles_fast16.launches = 0


def blend_tiles_query_plain(g_sorted, tile_start, tile_count, rows, bg,
                            grid_x, topk: int, phi, gram,
                            banded: bool = True,
                            cells_bf16: bool = False):
    """The fast16 plain blend (f32 outputs), then the query: products of
    bf16-rounded weights, phi and gram summed in f32; nrm2's last factor
    is the f32 weight."""
    L, K, PQ = phi.shape
    rgb, wm, T = blend_tiles_fast16_plain(g_sorted, tile_start, tile_count,
                                          rows, bg, grid_x, topk, L * K,
                                          False, banded, cells_bf16)
    t = wm.shape[0]
    wm = wm.reshape(t * P, L, K)
    wmb = round_bf16(wm)
    raw = torch.einsum("qlk,lkp->qlp", wmb, round_bf16(phi))
    wg = torch.einsum("qlm,lmk->qlk", wmb, round_bf16(gram))
    nrm2 = (wg * wm).sum(dim=-1)
    return rgb, raw.reshape(t, P, L * PQ), nrm2.reshape(t, P, L), T


def blend_tiles_query(g_sorted, tile_start, tile_count, rows, bg,
                      grid_x: int, grid_y: int, topk: int, phi, gram,
                      stats=None, *, banded: bool = True,
                      cells_bf16: bool = False):
    """The quick blend on fast16 rows with the Gram query fused (K2q).
    phi [L, K, PQ] and gram [L, K, K] f32 (the prompt constants of
    eval/openclip.py); other inputs as for `blend_tiles_fast16`, with
    L*K channels. Returns (rgb [T, 256, 3], raw [T, 256, L*PQ], nrm2
    [T, 256, L], final_T [T, 256]), all f32: raw[t,p,l*PQ+q] =
    sum_k wm[l,k] phi[l,k,q], nrm2[t,p,l] = sum_k (wm_l gram_l)[k] wm[l,k].
    `banded` and `cells_bf16` as for
    `blend_tiles_fast16`."""
    dev = rows.device
    n_tiles = grid_x * grid_y
    L, K, PQ = phi.shape
    if tuple(gram.shape) != (L, K, K):
        raise ValueError(f"gram {tuple(gram.shape)} does not match phi "
                         f"{tuple(phi.shape)}")
    if L * K > 256:
        raise ValueError(f"fast16 rows index at most 256 channels, not "
                         f"{L * K}")
    per_level = _per_level(banded, L * K, topk)
    if dev.type == "cpu":
        return blend_tiles_query_plain(g_sorted, tile_start, tile_count,
                                       rows, bg, grid_x, topk, phi, gram,
                                       banded, cells_bf16)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles_query: unsupported device {dev}")
    kernels.check_tensor(g_sorted, "g_sorted", torch.int32, (None,), dev)
    kernels.check_tensor(tile_start, "tile_start", torch.int32, (n_tiles,),
                         dev)
    kernels.check_tensor(tile_count, "tile_count", torch.int32, (n_tiles,),
                         dev)
    kernels.check_tensor(rows, "rows", torch.int32, (None, 16), dev)
    kernels.check_tensor(bg, "bg", torch.float32, (3,), dev)
    kernels.check_tensor(phi, "phi", torch.float32, (L, K, PQ), dev)
    kernels.check_tensor(gram, "gram", torch.float32, (L, K, K), dev)
    if rows.data_ptr() % 16:
        raise ValueError("rows: not 16-byte aligned")
    if not 0 < topk <= FAST16_PAIRS:
        raise ValueError(f"topk {topk} outside [1, {FAST16_PAIRS}]")
    if stats is not None:
        kernels.check_tensor(stats, "stats", torch.int64, (2,), dev)
    phi_b = round_bf16(phi).contiguous()
    gram_b = round_bf16(gram).contiguous()
    rgb = torch.empty((n_tiles, P, 3), device=dev)
    raw = torch.empty((n_tiles, P, L * PQ), device=dev)
    nrm2 = torch.empty((n_tiles, P, L), device=dev)
    final_t = torch.empty((n_tiles, P), device=dev)
    P_ = kernels.ptr
    args = (P_(g_sorted), P_(tile_start), P_(tile_count), P_(rows), P_(bg),
            P_(phi_b), P_(gram_b), n_tiles, grid_x, topk, L)
    outs = (P_(rgb), P_(raw), P_(nrm2), P_(final_t),
            P_(stats) if stats is not None else kernels.NULL)
    plan = kernel_plan(L, K, PQ, bf16=True)
    if plan["route"] == "main":
        kernels.launch("lsv2_blend_tiles_query", *args, PQ, per_level,
                       int(cells_bf16), *outs, kernels.stream(rgb))
    else:
        frag = torch.empty(plan["frag_words"], dtype=torch.int32, device=dev)
        kernels.launch("lsv2_blend_tiles_query_any", *args, K, PQ, per_level,
                       int(cells_bf16), *outs, P_(frag), plan["frag_words"],
                       kernels.stream(rgb))
    blend_tiles_query.launches += 1
    return rgb, raw, nrm2, final_t


blend_tiles_query.launches = 0


def blend_tiles_dense_plain(g_sorted, tile_start, tile_count, geom,
                            features, bg, grid_x):
    """The f32 blend of each entry's own feature row features[g] [N, D]."""
    dev = geom.device
    n_tiles = tile_start.shape[0]
    T = torch.ones((n_tiles, P), device=dev)
    acc = torch.zeros((n_tiles, P, 3), device=dev)
    feat = torch.zeros((n_tiles, P, features.shape[1]), device=dev)
    for _j, _live, g, row, w, T in replay_positions(
            g_sorted, tile_start, tile_count, geom, grid_x):
        acc += w[..., None] * row[:, None, 6:9]
        feat += w[..., None] * features[g][:, None, :]
    return acc + T[..., None] * bg, feat, T


def dense_groups(channels: int) -> list[tuple[int, int]]:
    """(first channel, width) of each dense launch: the fewest groups of
    at most DENSE_GROUP channels, equal widths rounded up to 4."""
    n = -(-channels // DENSE_GROUP)
    width = min(DENSE_GROUP, -(-(-(-channels // n)) // 4) * 4)
    return [(c0, min(width, channels - c0))
            for c0 in range(0, channels, width)]


def blend_tiles_dense(g_sorted, tile_start, tile_count, geom, features, bg,
                      grid_x: int, grid_y: int, stats=None):
    """K2's dense mode: (rgb [T, 256, 3], feat [T, 256, D], final_T
    [T, 256]) for features [N, D] f32, any D >= 1; other inputs as for
    `blend_tiles`. On CUDA one launch a channel group (`dense_groups`),
    rgb and final T from the first; `stats` counts the first group's
    pairs."""
    dev = geom.device
    n_tiles = grid_x * grid_y
    n, d = features.shape
    if d < 1:
        raise ValueError("dense features need at least one channel")
    if dev.type == "cpu":
        return blend_tiles_dense_plain(g_sorted, tile_start, tile_count,
                                       geom, features, bg, grid_x)
    if dev.type != "cuda":
        raise ValueError(f"blend_tiles_dense: unsupported device {dev}")
    kernels.check_tensor(g_sorted, "g_sorted", torch.int32, (None,), dev)
    kernels.check_tensor(tile_start, "tile_start", torch.int32, (n_tiles,),
                         dev)
    kernels.check_tensor(tile_count, "tile_count", torch.int32, (n_tiles,),
                         dev)
    kernels.check_tensor(geom, "geom", torch.float32, (n, 9), dev)
    kernels.check_tensor(features, "features", torch.float32, (n, d), dev)
    kernels.check_tensor(bg, "bg", torch.float32, (3,), dev)
    if stats is not None:
        kernels.check_tensor(stats, "stats", torch.int64, (2,), dev)
    rgb = torch.empty((n_tiles, P, 3), device=dev)
    feat = torch.empty((n_tiles, P, d), device=dev)
    final_t = torch.empty((n_tiles, P), device=dev)
    P_ = kernels.ptr
    null = kernels.NULL
    for c0, width in dense_groups(d):
        first = c0 == 0
        kernels.launch(
            "lsv2_blend_tiles_dense", P_(g_sorted), P_(tile_start),
            P_(tile_count), P_(geom), P_(features), P_(bg), n_tiles, grid_x,
            d, c0, width, P_(rgb) if first else null, P_(feat),
            P_(final_t) if first else null,
            P_(stats) if first and stats is not None else null,
            kernels.stream(feat))
        blend_tiles_dense.launches += 1
    return rgb, feat, final_t


blend_tiles_dense.launches = 0
