"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_port_*.py).

Scenes are made with numpy from a seed and handed to both the JAX
reference and the port, so the two sides see identical float32 inputs.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from langsplatv2_tpu_torch.utils.camera_math import (get_projection_matrix,
                                                     get_world_to_view)


def camera(h: int, w: int):
    """The bench camera: identity pose, 60 degree vertical field of view.
    Returns (view [4,4], proj [4,4], tanfovx, tanfovy) as float32 numpy."""
    fovy = math.radians(60)
    fovx = 2 * math.atan(math.tan(fovy / 2) * w / h)
    w2c = get_world_to_view(np.eye(3), np.zeros(3))
    view = np.asarray(w2c.T, np.float32)
    proj = np.asarray(w2c.T @ get_projection_matrix(0.01, 100, fovx, fovy).T,
                      np.float32)
    return view, proj, math.tan(fovx / 2), math.tan(fovy / 2)


def scene(n: int, seed: int = 0) -> dict:
    """Random splats in front of the bench camera (test_pallas_kernels.py
    `_scene` distribution): means, scales, rotations, opacities [n, 1],
    colors."""
    rng = np.random.default_rng(seed)
    return dict(
        means=np.concatenate([rng.uniform(-2, 2, (n, 2)),
                              rng.uniform(1.0, 8.0, (n, 1))], 1
                             ).astype(np.float32),
        scales=rng.uniform(0.02, 0.3, (n, 3)).astype(np.float32),
        rotations=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(0.1, 0.95, (n, 1)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
    )


def quick_pairs(n: int, levels: int = 3, k: int = 64, topk: int = 4,
                seed: int = 3):
    """Merged-model quick pairs: [n, levels*topk] weights summing to 1 and
    float32 indices, level l's in [l*k, (l+1)*k) (bench.py:246-250)."""
    rng = np.random.default_rng(seed)
    qw = rng.uniform(0, 1, (n, levels * topk)).astype(np.float32)
    qw /= qw.sum(1, keepdims=True)
    qi = np.concatenate([rng.integers(0, k, (n, topk)) + lvl * k
                         for lvl in range(levels)], 1).astype(np.float32)
    return qw, qi


def model_fields(n: int, seed: int = 0, levels: int = 3, k: int = 64,
                 dim: int = 512, topk: int = 4) -> dict:
    """Raw GaussianModel fields (langsplatv2_tpu/models/io.py MODEL_FIELDS)
    of a merged quick model at SH degree 0."""
    sc = scene(n, seed)
    rng = np.random.default_rng(seed + 100)
    qw, qi = quick_pairs(n, levels, k, topk, seed + 200)
    op = sc["opacities"]
    return dict(
        xyz=sc["means"],
        features_dc=((sc["colors"] - 0.5) / 0.28209479177387814
                     ).astype(np.float32)[:, None, :],
        features_rest=np.zeros((n, 0, 3), np.float32),
        scaling=np.log(sc["scales"]).astype(np.float32),
        rotation=sc["rotations"],
        opacity=np.log(op / (1 - op)).astype(np.float32),
        live=np.ones(n, bool),
        codebooks=rng.normal(size=(levels, k, dim)).astype(np.float32),
        quick_weights=qw,
        quick_indices=qi,
    )


def within_one_bf16_ulp(a, b, slack):
    """|a - b| <= one bf16 ulp of b + slack, elementwise."""
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=1e-30))) - 7)
    return bool(((a - b).abs() <= ulp + slack).all())


GOLDEN_EVAL = Path(__file__).resolve().parent / "golden" / "eval_golden.npz"


def golden_eval(device) -> dict:
    """The port's numbers for tests/golden/eval_golden.npz: the scene of
    scripts/make_golden_eval.py::compute (seed 42, 2,000 Gaussians,
    160x224, 3 levels x 64 codes, top-4 a level, 3 hash prompts, the same
    draws in the same order) rendered with impl="pallas" and the port's
    defaults (JAX's tile_cap 2048 and tile_batch 4 are read only by its
    reference rasterizer). Relevancy through the tiles and the Gram query
    (K3 on the card), and through the decoded map (get_max_across_quick);
    segmentation and localization on the first. Imports no JAX."""
    from langsplatv2_tpu_torch.eval import processing
    from langsplatv2_tpu_torch.eval.openclip import OpenCLIPNetwork
    from langsplatv2_tpu_torch.ops import rasterize_tiles
    from langsplatv2_tpu_torch.ops.rasterize import (RasterizeSettings,
                                                     rasterize)

    h, w, n, levels, k, topk, n_prompt = 160, 224, 2000, 3, 64, 4, 3
    rng = np.random.default_rng(42)
    means = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                            rng.uniform(2.0, 9.0, (n, 1))], axis=1
                           ).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, (n, 3)).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    ops = rng.uniform(0.3, 0.95, (n, 1)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    qw = rng.uniform(0, 1, (n, levels * topk)).astype(np.float32)
    qw /= qw.sum(1, keepdims=True)
    qi = np.concatenate([rng.integers(0, k, (n, topk)) + lvl * k
                         for lvl in range(levels)], 1).astype(np.int32)
    codebooks = rng.normal(size=(levels, k, 512)).astype(np.float32)
    codebooks /= np.linalg.norm(codebooks, axis=2, keepdims=True)

    view, pm, tfx, tfy = camera(h, w)
    s = RasterizeSettings(image_height=h, image_width=w, tanfovx=tfx,
                          tanfovy=tfy, sh_degree=0, max_entries=2 ** 17,
                          impl="pallas", assemble=False)
    zeros = np.zeros(3, np.float32)
    with torch.no_grad():
        out = rasterize(s, means, ops, view, pm, zeros, zeros, scales=scales,
                        rotations=rots, colors_precomp=cols,
                        quick_weights=qw, quick_indices=qi,
                        quick_channels=levels * k, device=device)
        clip = OpenCLIPNetwork(backend="hash", device=device)
        prompts = [f"prompt {i}" for i in range(n_prompt)]
        clip.set_positives(prompts)
        cb = torch.as_tensor(codebooks, device=device)
        rel_gram = clip.relevancy_from_tiles(
            out.feature_map, *clip.prompt_constants(cb), s.grid_x, s.grid_y,
            h, w)
        wmap = rasterize_tiles.tiles_to_image(out.feature_map, s.grid_x,
                                              s.grid_y, h, w)
        feats = torch.einsum("lkd,lkp->ldp", cb, wmap.reshape(levels, k,
                                                              h * w))
        feats = feats / (torch.linalg.norm(feats, dim=1, keepdim=True)
                         + 1e-10)
        rel_decode = clip.get_max_across_quick(
            feats.reshape(levels, 512, h, w).permute(0, 2, 3, 1))
    gt_masks, gt_boxes = {}, {}
    for i, p in enumerate(prompts):
        m = np.zeros((h, w), np.uint8)
        y0, x0 = 20 + 30 * i, 30 + 40 * i
        m[y0:y0 + 60, x0:x0 + 80] = 1
        gt_masks[p] = m
        gt_boxes[p] = np.asarray([[x0, y0, x0 + 80, y0 + 60]])
    chosen_iou, chosen_lvl, _ = processing.segmentation_process(
        rel_gram, 0.4, gt_masks, prompts)
    hits = processing.localization_process(rel_gram, gt_boxes, prompts)
    return {
        "rel_gram": rel_gram.cpu().numpy(),
        "rel_decode": rel_decode.cpu().numpy(),
        "chosen_iou": np.asarray(chosen_iou, np.float32),
        "chosen_lvl": np.asarray(chosen_lvl, np.int32),
        "localization_hits": np.asarray(hits, np.int32),
        "total_entries": int(out.total_entries),
    }


def check_golden_eval(vals: dict, atol: float = 1e-5) -> dict:
    """Hold golden_eval's numbers to the fixture at the fixture test's own
    atol: rel_gram, chosen_iou, chosen_lvl, localization_hits, and the
    decoded route's relevancy against the fixture's rel_gram (whose own
    decode sits 2.7e-7 from it). Returns the largest differences."""
    ref = np.load(GOLDEN_EVAL)
    assert vals["total_entries"] < 2 ** 17, "the golden frame overflowed"
    errs = {}
    for key, ref_key in (("rel_gram", "rel_gram"), ("rel_decode", "rel_gram"),
                         ("chosen_iou", "chosen_iou"),
                         ("chosen_lvl", "chosen_lvl"),
                         ("localization_hits", "localization_hits")):
        np.testing.assert_allclose(vals[key], ref[ref_key], atol=atol,
                                   rtol=0, err_msg=key)
        errs[key] = float(np.abs(vals[key].astype(np.float64)
                                 - ref[ref_key]).max())
    return errs


GRAM_PATTERNS = ("warp_segments", "masked", "distinct")


def gram_pattern_case(pattern: str, m: int, tiles: int = 1, seed: int = 0,
                      segments: int = 300, k: int = 64) -> dict:
    """Inputs of the Gram-loss backward at G [m, m] (layer m / k - 1 of
    K = k) whose tiles [tiles, 256] (tile-pixel order) all follow one
    segment pattern: "warp_segments", two pixel rows (32 pixels) a segment
    with ~5% -1 holes; "masked", every pixel -1; "distinct", 256 distinct
    ids. The map w [tiles, 256, m] has ~10% zero pixels; codebooks
    [m / k, k, 32] and the table [segments, 32] are standard normal."""
    rng = np.random.default_rng(seed)
    seg = np.empty((tiles, 256), np.int32)
    for t in range(tiles):
        if pattern == "warp_segments":
            seg[t] = np.repeat(rng.integers(0, segments, 8), 32)
            seg[t, rng.uniform(size=256) < 0.05] = -1
        elif pattern == "masked":
            seg[t] = -1
        else:
            seg[t] = rng.permutation(segments)[:256]
    w = rng.standard_normal((tiles, 256, m)).astype(np.float32)
    w[rng.uniform(size=(tiles, 256)) < 0.1] = 0.0
    return dict(seg=seg, w=w,
                codebooks=rng.standard_normal((m // k, k, 32)).astype(
                    np.float32),
                table=rng.standard_normal((segments, 32)).astype(np.float32))


# Tile counts that sit on K4's batch (32), K7's group (4) and batch (64)
# edges (and 16, 8), an empty tile with a misaligned start, ~300 entries,
# a tile whose every pixel ends mid-batch and mid-group, a tile whose
# entries 8..31 no pixel includes, and an empty last tile.
BWD_EDGE_COUNTS = (1, 7, 8, 9, 0, 15, 16, 17, 31, 32, 33, 63, 64, 65, 300)
BWD_END_TILE, BWD_END_AT, BWD_DARK_TILE = 15, 21, 16


def bwd_edge_case(seed: int = 0, tail: int = 5) -> dict:
    """Inputs of the training backwards (K4, K7) on a 6 x 3 tile grid with
    BWD_EDGE_COUNTS' segments, then tile BWD_END_TILE (150 entries that
    cover the whole tile: every pixel ends on entry BWD_END_AT), tile
    BWD_DARK_TILE (40 entries, 8..31 of opacity 0.002: alpha below 1/255
    everywhere) and an empty tile. g_sorted has `tail` entries past the
    last tile's range. Returns numpy arrays g, start, count, geom [N, 9]
    and the grid."""
    rng = np.random.default_rng(seed)
    gx, gy = 6, 3
    counts = list(BWD_EDGE_COUNTS) + [150, 40, 0]
    rows = []
    for t, c in enumerate(counts):
        ox, oy = (t % gx) * 16, (t // gx) * 16
        r = np.zeros((c, 9), np.float32)
        r[:, 0] = ox + rng.uniform(-4, 20, c)
        r[:, 1] = oy + rng.uniform(-4, 20, c)
        s = rng.uniform(2.0, 9.0, (c, 2))
        r[:, 2] = 1 / s[:, 0] ** 2
        r[:, 3] = rng.uniform(-0.3, 0.3, c) / (s[:, 0] * s[:, 1])
        r[:, 4] = 1 / s[:, 1] ** 2
        r[:, 5] = rng.uniform(0.2, 0.95, c)
        r[:, 6:9] = rng.uniform(0, 1, (c, 3))
        if t == BWD_END_TILE:
            # BWD_END_AT wide entries of alpha a ((1 - a)^BWD_END_AT =
            # 1e-3), then alpha 0.99: T falls below 1e-4 on that entry.
            n = BWD_END_AT
            r[:n + 1, 0:2] = [ox + 7.5, oy + 7.5]
            r[:n + 1, 2:5] = [1e-6, 0.0, 1e-6]
            r[:n, 5] = 1.0 - 1e-3 ** (1.0 / n)
            r[n, 5] = 0.99
        if t == BWD_DARK_TILE:
            r[8:32, 5] = 0.002
        rows.append(r)
    rows.append(rng.uniform(0, 1, (tail, 9)).astype(np.float32))
    geom = np.concatenate(rows)
    count = np.array(counts, np.int32)
    start = (np.cumsum(count) - count).astype(np.int32)
    return dict(g=np.arange(geom.shape[0], dtype=np.int32), start=start,
                count=count, geom=geom, grid_x=gx, grid_y=gy)


# K1's edge cases, on an 8 x 6 tile grid (128 x 96 pixels) unless a test
# asks for another: runs of zero-tile Gaussians before, between and after
# the live ones, one whole-grid rect whose far tiles the cull kills, and
# rects of 1 to 20 tiles.
EXPAND_GRID = (8, 6)


def _expand_rects(rng, gx: int, gy: int) -> list:
    rects = [(3, 2, 3, 4)] * 3                    # zero-tile run first
    rects.append((0, 0, gx, gy))                  # the whole grid
    for i in range(24):
        if i in (6, 15):
            rects += [(1, 1, 1, 1), (5, 0, 7, 0), (2, 3, 2, 5), (0, 0, 0, 0)]
        w, h = int(rng.integers(1, 6)), int(rng.integers(1, 5))
        x0 = int(rng.integers(0, gx - w + 1))
        y0 = int(rng.integers(0, gy - h + 1))
        rects.append((x0, y0, x0 + w, y0 + h))
    return rects + [(4, 4, 4, 6)] * 2             # zero-tile run last


def expand_edge_case(seed: int = 0, live: bool = True,
                     grid: tuple = EXPAND_GRID, copies: int = 1) -> dict:
    """Projected Gaussians (numpy: xy, depth, conic, radius, rgb, rect_min,
    rect_max, tiles_touched with tiles = rect width * height, and
    opacities) for K1's edges, `copies` draws of the sequence one after
    another, and `cuts`: max_entries values that leave a tail past the
    total, cut the whole-grid rect (the first live one) in the middle, and
    cut one slot before and one after the end of a rect that a zero-tile
    run follows. With live=False every Gaussian touches 0 tiles (no live
    entry)."""
    rng = np.random.default_rng(seed)
    gx, gy = grid
    rects = [r for _ in range(copies) for r in _expand_rects(rng, gx, gy)]
    r = np.array(rects, np.int32)
    if not live:
        r[:, 2] = r[:, 0]
    n = r.shape[0]
    tiles = ((r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])).astype(np.int32)
    # Centres inside the rect, covariances of 3-15 pixels, some tilted; the
    # whole-grid Gaussians sit at the grid's centre with sigma a sixth of
    # its width, so the cull kills its far tiles.
    lo, hi = r[:, :2] * 16.0, np.maximum(r[:, 2:], r[:, :2] + 1) * 16.0
    xy = rng.uniform(lo, hi).astype(np.float32)
    sig = rng.uniform(3.0, 15.0, (n, 2))
    rho = rng.uniform(-0.6, 0.6, n)
    whole = (r[:, 2] - r[:, 0] == gx) & (r[:, 3] - r[:, 1] == gy)
    xy[whole] = (8.0 * gx, 8.0 * gy)
    sig[whole] = 16.0 * gx / 6
    rho[whole] = 0.0
    det = (sig[:, 0] * sig[:, 1]) ** 2 * (1 - rho ** 2)
    conic = np.stack([sig[:, 1] ** 2 / det,
                      -rho * sig[:, 0] * sig[:, 1] / det,
                      sig[:, 0] ** 2 / det], 1).astype(np.float32)
    ends = np.cumsum(tiles)
    b = int(ends[9])
    cuts = ([int(ends[-1]) + 37, int(ends[3] - tiles[3] // 2), b - 1, b + 1]
            if live else [37, 1])
    return dict(
        xy=xy, depth=rng.uniform(1.0, 9.0, n).astype(np.float32),
        conic=conic, radius=np.where(tiles > 0, 8, 0).astype(np.int32),
        rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        rect_min=np.ascontiguousarray(r[:, :2]),
        rect_max=np.ascontiguousarray(r[:, 2:]), tiles_touched=tiles,
        opacities=rng.uniform(0.1, 0.95, n).astype(np.float32),
        cuts=cuts, grid_x=gx, grid_y=gy)


# K8's edges (tests/test_torch_port_cascade_edges.py against JAX on the CPU,
# tests/test_torch_port_gpu.py the kernel against its plain version):
# "level0": rects one tile wide, so level 1 keeps at most what level 0 does
# and only level 0 can run past a budget; "level1": rects one row high and
# up to 30 wide, so only level 1 can; "wide": rects of 65-90 tiles on a
# 90 x 3 grid (past the 64 tiles an item's keep bits cover) whose far tiles
# the cull drops; "widest": a 1,024 x 2 grid, rects up to 1,024 wide;
# "column": a 1 x 20 grid; "chunks": rows of exactly 256, 255, 257, 512 and
# 0 items, 1,280 Gaussians in all (the kernel's 256-item chunk edges);
# "dead": no Gaussian touches a tile; "none": no Gaussian at all. Depths
# repeat (ties go by id) and a few are negative (the order reads |depth|).
CASCADE_EDGES = ("level0", "level1", "wide", "widest", "column", "chunks",
                 "dead", "none")
CASCADE_FIELDS = ("xy", "depth", "conic", "radius", "rgb", "rect_min",
                  "rect_max", "tiles_touched")


def _cascade_rects(kind: str, rng):
    """(grid_x, grid_y, rects [n, 4] x0 y0 x1 y1, pixel sigmas [n, 2])."""
    def spans(n, extent, lo_w, hi_w):
        w = rng.integers(lo_w, hi_w + 1, n)
        w = np.minimum(w, extent)
        x0 = rng.integers(0, extent - w + 1)
        return x0, x0 + w

    if kind == "level0":
        gx, gy, n = 6, 10, 300
        x0 = rng.integers(0, gx, n)
        y0, y1 = spans(n, gy, 3, 8)
        r = np.stack([x0, y0, x0 + 1, y1], 1)
        sig = np.stack([rng.uniform(2, 5, n), rng.uniform(30, 60, n)], 1)
    elif kind == "level1":
        gx, gy, n = 40, 4, 200
        x0, x1 = spans(n, gx, 5, 30)
        y0 = rng.integers(0, gy, n)
        r = np.stack([x0, y0, x1, y0 + 1], 1)
        sig = np.stack([rng.uniform(40, 160, n), rng.uniform(2, 5, n)], 1)
    elif kind in ("wide", "widest"):
        gx, gy, n = (90, 3, 60) if kind == "wide" else (1024, 2, 40)
        x0, x1 = spans(n, gx, 65 if kind == "wide" else 1, gx)
        y0, y1 = spans(n, gy, 1, gy)
        r = np.stack([x0, y0, x1, y1], 1)
        sig = np.stack([rng.uniform(60, 16 * gx / 5, n),
                        rng.uniform(4, 12, n)], 1)
    elif kind == "column":
        gx, gy, n = 1, 20, 150
        y0, y1 = spans(n, gy, 1, 6)
        r = np.stack([np.zeros(n, int), y0, np.ones(n, int), y1], 1)
        sig = rng.uniform(3, 20, (n, 2))
    elif kind == "chunks":
        gx, gy = 4, 5
        y0 = np.repeat(np.arange(5), [256, 255, 257, 512, 0])
        n = y0.shape[0]
        x0, x1 = spans(n, gx, 1, 4)
        r = np.stack([x0, y0, x1, y0 + 1], 1)
        sig = rng.uniform(3, 30, (n, 2))
    elif kind in ("dead", "none"):
        gx, gy, n = 8, 6, 50 if kind == "dead" else 0
        x0 = rng.integers(0, gx, n)
        y0 = rng.integers(0, gy, n)
        r = np.stack([x0, y0, x0, y0 + 1], 1).reshape(n, 4)
        sig = rng.uniform(3, 20, (n, 2))
    else:
        raise ValueError(kind)
    return gx, gy, r.astype(np.int32), sig


def cascade_edge_case(kind: str, seed: int = 0) -> dict:
    """Projected Gaussians (numpy, as `expand_edge_case`) for K8's edge
    `kind` (CASCADE_EDGES), with grid_x and grid_y. Centres lie inside the
    rect, so the cull keeps the centre's tiles and drops far ones."""
    rng = np.random.default_rng(seed)
    gx, gy, r, sig = _cascade_rects(kind, rng)
    n = r.shape[0]
    tiles = ((r[:, 2] - r[:, 0]) * (r[:, 3] - r[:, 1])).astype(np.int32)
    lo, hi = r[:, :2] * 16.0, np.maximum(r[:, 2:], r[:, :2] + 1) * 16.0
    xy = rng.uniform(lo, hi).astype(np.float32).reshape(n, 2)
    rho = rng.uniform(-0.5, 0.5, n)
    det = (sig[:, 0] * sig[:, 1]) ** 2 * (1 - rho ** 2)
    conic = np.stack([sig[:, 1] ** 2 / det,
                      -rho * sig[:, 0] * sig[:, 1] / det,
                      sig[:, 0] ** 2 / det], 1).astype(np.float32)
    depth = (rng.integers(2, 40, n) / 4.0).astype(np.float32)
    depth[rng.random(n) < 0.05] *= -1.0
    return dict(
        xy=xy, depth=depth, conic=conic.reshape(n, 3),
        radius=np.where(tiles > 0, 8, 0).astype(np.int32),
        rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        rect_min=np.ascontiguousarray(r[:, :2]),
        rect_max=np.ascontiguousarray(r[:, 2:]), tiles_touched=tiles,
        opacities=rng.uniform(0.1, 0.95, n).astype(np.float32),
        grid_x=gx, grid_y=gy)


def cascade_budgets(kind: str, rows_total: int, count_full) -> list:
    """Budgets at the edges of `kind` from the rows' total (level 0's
    entries) and the per-tile counts without a budget: the kept total and
    one below it, the least budget that neither level runs past (the larger
    of the two totals) and one below it, a tile's segment end and one
    below it, and for "level0" one below the rows' total and half of it.
    Each is at least 0."""
    count_full = np.asarray(count_full).astype(np.int64)
    ends = np.cumsum(count_full)
    total = int(ends[-1]) if ends.size else 0
    mid = int(ends[ends.size // 2]) if ends.size else 0
    least = max(total, rows_total)
    budgets = [least + 1000, least, least - 1, total, total - 1, mid,
               mid - 1]
    if kind == "level0":
        budgets += [rows_total - 1, rows_total // 2]
    elif kind == "level1":
        budgets += [rows_total, (rows_total + total) // 2]
    return sorted({max(b, 0) for b in budgets})


# K5's windows: kept counts on the batch (32) edges, a window one short of
# full and a full one, a window whose every pixel ends on entry
# CAPPED_END_AT, one whose entries 8..31 no pixel includes, and an empty
# last tile, on a 5 x 2 grid.
CAPPED_EDGE_KEPT = (0, 1, 31, 32, 33)
CAPPED_END_TILE, CAPPED_END_AT, CAPPED_DARK_TILE = 7, 21, 8


def capped_edge_case(cap: int, topk: int, channels: int,
                     seed: int = 0) -> dict:
    """Inputs of K5 (numpy): the capped windows g_win [T * cap] (each kept
    slot its own Gaussian, unused slots id 0), kept [T], geom [N, 9],
    quick_indices [N, topk] in [0, channels), quick_weights [N, topk] and
    a cotangent [T, 256, channels]; kept is CAPPED_EDGE_KEPT, cap - 1,
    cap, the ending window (cap entries), the dark window (40) and 0."""
    rng = np.random.default_rng(seed)
    gx, gy = 5, 2
    kept = list(CAPPED_EDGE_KEPT) + [cap - 1, cap, cap, 40, 0]
    rows, g_win = [np.zeros((1, 9), np.float32)], []
    for t, c in enumerate(kept):
        ox, oy = (t % gx) * 16, (t // gx) * 16
        r = np.zeros((c, 9), np.float32)
        r[:, 0] = ox + rng.uniform(-4, 20, c)
        r[:, 1] = oy + rng.uniform(-4, 20, c)
        s = rng.uniform(2.0, 9.0, (c, 2))
        r[:, 2] = 1 / s[:, 0] ** 2
        r[:, 3] = rng.uniform(-0.3, 0.3, c) / (s[:, 0] * s[:, 1])
        r[:, 4] = 1 / s[:, 1] ** 2
        r[:, 5] = rng.uniform(0.2, 0.95, c)
        r[:, 6:9] = rng.uniform(0, 1, (c, 3))
        if t == CAPPED_END_TILE:
            n = CAPPED_END_AT
            r[:n + 1, 0:2] = [ox + 7.5, oy + 7.5]
            r[:n + 1, 2:5] = [1e-6, 0.0, 1e-6]
            r[:n, 5] = 1.0 - 1e-3 ** (1.0 / n)
            r[n, 5] = 0.99
        if t == CAPPED_DARK_TILE:
            r[8:32, 5] = 0.002
        first = sum(len(x) for x in rows)
        rows.append(r)
        g_win += list(range(first, first + c)) + [0] * (cap - c)
    geom = np.concatenate(rows)
    n = geom.shape[0]
    qw = rng.uniform(0, 1, (n, topk)).astype(np.float32)
    return dict(g_win=np.array(g_win, np.int32),
                kept=np.array(kept, np.int32), geom=geom,
                qi=rng.integers(0, channels, (n, topk)).astype(np.int32),
                qw=qw / qw.sum(1, keepdims=True),
                cot=rng.standard_normal((gx * gy, 256, channels)).astype(
                    np.float32),
                grid_x=gx, grid_y=gy, cap=cap)


def write_colmap_scene(root: Path, rng, n_imgs: int = 6, n_pts: int = 60,
                       h: int = 48, w: int = 64, n_seg: int = 3) -> None:
    """A tiny COLMAP scene directory (tests/test_cli.py::_build_scene,
    written with the port's writers and PIL): sparse/0 (one PINHOLE camera,
    `n_imgs` views stepping along x, `n_pts` points), images/*.png, and
    language_features/*_s.npy [4, h, w] (three regions) and *_f.npy
    [n_seg, 512]."""
    from PIL import Image

    from langsplatv2_tpu_torch.scene import colmap

    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    colmap.write_intrinsics_binary(str(sparse / "cameras.bin"), {
        1: colmap.ColmapCamera(1, "PINHOLE", w, h,
                               np.array([60.0, 60.0, w / 2, h / 2]))})
    colmap.write_extrinsics_binary(str(sparse / "images.bin"), {
        i: colmap.ColmapImage(i, np.array([1.0, 0, 0, 0]),
                              np.array([0.1 * i, 0.0, 4.0]), 1,
                              f"img_{i:03d}.png")
        for i in range(1, n_imgs + 1)})
    xyz = np.concatenate([rng.uniform(-1, 1, (n_pts, 2)),
                          rng.uniform(1.0, 3.0, (n_pts, 1))], 1)
    colmap.write_points3d_binary(str(sparse / "points3D.bin"), xyz,
                                 rng.uniform(size=(n_pts, 3)))
    (root / "images").mkdir()
    lf = root / "language_features"
    lf.mkdir()
    feats = rng.normal(size=(n_seg, 512)).astype(np.float32)
    for i in range(1, n_imgs + 1):
        Image.fromarray((rng.uniform(size=(h, w, 3)) * 255).astype(
            np.uint8)).save(root / "images" / f"img_{i:03d}.png")
        seg = np.zeros((4, h, w), np.int32)
        seg[:, :, w // 2:] = 1
        seg[:, :h // 6] = n_seg - 1
        np.save(lf / f"img_{i:03d}_s.npy", seg)
        np.save(lf / f"img_{i:03d}_f.npy", feats + 0.1 * rng.normal(
            size=feats.shape).astype(np.float32))


class LanguageCamera:
    """A camera with its matrices and a compact GT, readable by both
    packages' trainers (neither reads an image in the feature phase)."""

    def __init__(self, h: int, w: int, tx: float, name: str, table, seg):
        fovy = math.radians(60)
        fovx = 2 * math.atan(math.tan(fovy / 2) * w / h)
        w2c = get_world_to_view(np.eye(3), np.array([tx, 0.0, 0.0]))
        self.world_view_transform = np.asarray(w2c.T, np.float32)
        self.full_proj_transform = np.asarray(
            w2c.T @ get_projection_matrix(0.01, 100, fovx, fovy).T,
            np.float32)
        self.camera_center = np.asarray(np.linalg.inv(w2c.T)[3, :3],
                                        np.float32)
        self.tanfovx, self.tanfovy = math.tan(fovx / 2), math.tan(fovy / 2)
        self.image_height, self.image_width = h, w
        self.image_name = name
        self._gt = (table, seg)

    def get_language_feature_compact(self, lf_dir, level):
        return self._gt


def two_camera_feature_scene(seed: int = 5, n: int = 30, h: int = 48,
                             w: int = 64, k: int = 16):
    """tests/test_training.py::_two_cam_feature_scene with numpy draws:
    `n` Gaussians (create_from_pcd, opacity logit 2) in a right and a left
    half, random logits and one level of `k` codes, and two cameras 0.15
    apart sharing one (H, W, fov) signature whose GT is a two-segment
    one-hot table split at the middle column. Returns (model fields as
    numpy, cameras)."""
    from langsplatv2_tpu_torch.models.gaussians import create_from_pcd

    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-2, 2, (n, 2)),
                          rng.uniform(2.0, 8.0, (n, 1))], 1).astype(np.float32)
    pts[:n // 2, 0] = np.abs(pts[:n // 2, 0])
    pts[n // 2:, 0] = -np.abs(pts[n // 2:, 0])
    model = create_from_pcd(pts, np.full((n, 3), 0.5, np.float32), 1.0,
                            device="cpu")
    fields = {name: v.detach().numpy().copy()
              for name, v in model.fields().items() if v is not None}
    fields["opacity"] = np.full((n, 1), 2.0, np.float32)
    fields["language_logits"] = rng.normal(size=(n, k)).astype(np.float32)
    fields["codebooks"] = rng.normal(size=(1, k, 512)).astype(np.float32)
    table = np.zeros((2, 512), np.float32)
    table[0, 0] = table[1, 1] = 1.0
    seg = np.zeros((h, w), np.int32)
    seg[:, w // 2:] = 1
    cams = [LanguageCamera(h, w, tx, f"fake{i}", table, seg)
            for i, tx in enumerate((0.0, 0.15))]
    return fields, cams
