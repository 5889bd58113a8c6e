#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
1. environment: GPU name and power limit (nvidia-smi), torch and CUDA;
2. build: nvcc builds the kernels from langsplatv2_tpu_torch/csrc;
3. kernel checks on a reduced scene (50k Gaussians, 512x512): each CUDA
   kernel against its plain PyTorch version on the card — K1 expansion
   exact, K2 blend (quick and rgb) atol 3e-5, K3 query rtol/atol 1e-5;
4. the main path at full width: the bench scene (1M Gaussians, seed 0;
   3 levels x 64 codes x 512-d, top-4 a level = 12 pairs, 192 channels),
   1 positive + 4 negative prompts, render(quick_render=True) +
   relevancy_from_tiles for 5 frames at 1920x1080 and at 986x728, with
   the entry budget sized as bench.py sizes it; launch counters are zeroed
   just before and read just after;
5. at both loads, each kernel on the main path's own inputs held against
   its plain version on the same inputs (tolerances as in phase 3) and
   timed beside it, with its bound for this run's data and (K3) the
   einsum form;
6. training kernels on a reduced scene (50k Gaussians, 272x480): K6a
   (per-tile sums rtol 1e-5 / atol 1e-4), K6b (1e-4 of its largest
   output) and K4 (1e-5 of its largest output) against their plain
   versions on one step's inputs, the fused loss against the plain
   autograd of trainer._gram_cos_core (value rtol 1e-5, gradients 1e-4),
   and K6 at M = 192 on random inputs;
7. the training slice at full width (scripts/profile_train.py's scene:
   300k Gaussians, 544x960, L=1, K=64, top-4, a 512-row GT table, 4
   cameras): train_features for 20 steps with the launch counters zeroed
   just before and read just after; fails unless K1, K2, K4, K6a and K6b
   all launched, the loss is finite and falls, and no budget saturates;
   then K4/K6a/K6b on one step's own inputs against their plain versions
   (as in phase 6) and timed beside their bounds, with the step's stages
   timed alone.
It prints the kernels line (max_abs_err: the largest of phases 3 and 5,
or 6 and 7) and, last, {"ok": true, "device": {...}}.
Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from langsplatv2_tpu_torch.eval.openclip import OpenCLIPNetwork
from langsplatv2_tpu_torch.models.gaussians import (from_numpy_params,
                                                    init_language_features)
from langsplatv2_tpu_torch.models.renderer import make_settings, render
from langsplatv2_tpu_torch.ops import (blend, expand, gram, kernels,
                                       projection, query, train)
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings, \
    sorted_binning
from langsplatv2_tpu_torch.scene.cameras import Camera
from langsplatv2_tpu_torch.train import trainer
from langsplatv2_tpu_torch.utils.camera_math import (get_projection_matrix,
                                                     get_world_to_view)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate, f32 rate outside
# the tensor cores, and f32-accurate tensor-core products (3xTF32: a third
# of the 495 TFLOP/s TF32 rate), the floor for K3's matrix products.
# Rates assume the 700 W limit; the card's limit is printed.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F32_TENSOR_FLOPS = 495e12 / 3
L, K, TOPK, DIM = 3, 64, 4, 512
PROMPTS = ["teddy bear"]              # + the 4 canonical negatives
LOADS = [("1080p", 1080, 1920, 5_300_000), ("986x728", 728, 986, 3_900_000)]
FRAMES = 5
# f32 operations per (entry, pixel) pair in K2: the alpha test (dx, dy,
# the conic quadratic, exp, scale, clamp), and for an included pair the
# transmittance step plus rgb and top-k accumulates (2 each).
BLEND_ALPHA_FLOPS = 14
BLEND_INCLUDE_FLOPS = 3 + 2 * (3 + L * TOPK)
CULL_FLOPS = 60                       # K1's exact cull per entry
KERNELS = {
    "K1": ("expand_entries", "langsplatv2_tpu_torch/csrc/expand.cu",
           "langsplatv2_tpu/ops/pallas_binning.py:498"),
    "K2": ("blend_tiles", "langsplatv2_tpu_torch/csrc/blend.cu",
           "langsplatv2_tpu/ops/pallas_blend.py:695"),
    "K3": ("query_map_tiles", "langsplatv2_tpu_torch/csrc/query.cu",
           "langsplatv2_tpu/ops/pallas_query.py:92"),
    "K4": ("feature_grads", "langsplatv2_tpu_torch/csrc/feature_bwd.cu",
           "langsplatv2_tpu/ops/pallas_train.py:241"),
    "K6a": ("gram_tiles_fwd", "langsplatv2_tpu_torch/csrc/gram.cu",
            "langsplatv2_tpu/ops/pallas_gram.py:175"),
    "K6b": ("gram_tiles_bwd", "langsplatv2_tpu_torch/csrc/gram.cu",
            "langsplatv2_tpu/ops/pallas_gram.py:205"),
}
WRAPPERS = {"K1": expand.expand_entries, "K2": blend.blend_tiles,
            "K3": query.query_map_tiles}
TRAIN_WRAPPERS = {"K1": expand.expand_entries, "K2": blend.blend_tiles,
                  "K4": train.feature_grads, "K6a": gram.gram_tiles_fwd,
                  "K6b": gram.gram_tiles_bwd}
# The training slice (scripts/profile_train.py's scene): 300k Gaussians at
# 544x960, one level of 64 codes, top-4, a 512-row GT table.
TRAIN_N, TRAIN_H, TRAIN_W, TRAIN_K, TRAIN_TOPK, TRAIN_S = (
    300_000, 544, 960, 64, 4, 512)
TRAIN_ITERS = 20
TRAIN_YAW_DEG = (-6.0, -2.0, 2.0, 6.0)    # 4 cameras around the scene
GT_DIR = os.path.join("build", "chip_smoke_gt")


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bench_scene(n: int, seed: int = 0) -> dict:
    """bench.py:238-251 (same draws in the same order), as GaussianModel
    fields: SH degree 0 colour, log-scale, logit opacity."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.uniform(-4, 4, (n, 2)),
                            rng.uniform(2.0, 12.0, (n, 1))], 1).astype(np.float32)
    scales = rng.uniform(0.004, 0.04, (n, 3)).astype(np.float32)
    rotations = rng.normal(size=(n, 4)).astype(np.float32)
    opacities = rng.uniform(0.2, 0.95, (n, 1)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    qw = rng.uniform(0, 1, (n, L * TOPK)).astype(np.float32)
    qw /= qw.sum(1, keepdims=True)
    qi = np.concatenate([rng.integers(0, K, (n, TOPK)) + lvl * K
                         for lvl in range(L)], axis=1).astype(np.float32)
    codebooks = rng.normal(size=(L, K, DIM)).astype(np.float32)
    return dict(
        xyz=means, scaling=np.log(scales), rotation=rotations,
        opacity=np.log(opacities / (1 - opacities)),
        features_dc=((colors - 0.5) / 0.28209479177387814)[:, None, :],
        features_rest=np.zeros((n, 0, 3), np.float32),
        quick_weights=qw, quick_indices=qi, codebooks=codebooks)


def bench_camera(h: int, w: int):
    fovy = math.radians(60)
    fovx = 2 * math.atan(math.tan(fovy / 2) * w / h)
    w2c = get_world_to_view(np.eye(3), np.zeros(3))
    view = np.asarray(w2c.T, np.float32)
    proj = np.asarray(w2c.T @ get_projection_matrix(0.01, 100, fovx, fovy).T,
                      np.float32)
    return view, proj, math.tan(fovx / 2), math.tan(fovy / 2)


def cuda_ms(fn, reps: int):
    """(mean device time of fn() over reps launches after one warm-up
    call, the warm-up call's result)."""
    out = fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound(nbytes: float, flops: float,
          rate: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def stage_inputs(model, settings, view, pm, clip_consts, dev):
    """The inputs each kernel gets on the main path (same calls as
    rasterize), for timing the kernels alone."""
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    op = model.get_opacity()[:, 0].contiguous()
    proj = projection.preprocess(
        model.xyz, model.get_scaling(), model.get_rotation(),
        model.get_features(), None, T(view), T(pm), torch.zeros(3, device=dev),
        settings.tanfovx, settings.tanfovy, settings.image_width,
        settings.image_height, 0, opacities=op)
    g, start, count, total, live = sorted_binning(settings, proj, op)
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, op, proj.rgb)
    return dict(proj=proj, op=op, g=g, start=start, count=count,
                total=int(total), live=int(live), geom=geom,
                bg=torch.zeros(3, device=dev),
                qw=model.quick_weights.contiguous(),
                qi=model.quick_indices.contiguous(),
                phi=clip_consts[0], gram=clip_consts[1])


def check_kernels(dev) -> dict:
    """Phase 3: every kernel against its plain version, reduced scene."""
    h = w = 512
    model = from_numpy_params(bench_scene(50_000, seed=1), device=dev)
    view, pm, tfx, tfy = bench_camera(h, w)
    s = RasterizeSettings(h, w, tfx, tfy, 0, max_entries=1 << 20)
    clip = OpenCLIPNetwork("hash", device=dev)
    clip.set_positives(PROMPTS)
    x = stage_inputs(model, s, view, pm, clip.prompt_constants(model.codebooks),
                     dev)
    gx, gy = s.grid_x, s.grid_y
    errs = {}

    tile, depth, gauss, total = expand.expand_entries(
        x["proj"], x["op"], gx, gy, s.max_entries)
    proj = x["proj"]
    offsets = torch.cumsum(proj.tiles_touched, 0, dtype=torch.int64) \
        - proj.tiles_touched
    ref = expand.expand_entries_plain(proj, x["op"], offsets, gx, gy,
                                      s.max_entries, True,
                                      float(np.float32(255.0)))
    pairs = list(zip((tile, depth, gauss), ref))
    mismatch = sum(int((a != b).sum()) for a, b in pairs)
    errs["K1"] = max_diff(pairs)
    log(f"K1 expand: total {int(total)} entries, {mismatch} differ from the "
        f"plain version (must be 0)")
    if mismatch or int(total) >= s.max_entries:
        fail("K1 expansion differs from its plain version or overflowed")

    args = (x["g"], x["start"], x["count"], x["geom"], x["bg"], gx)
    out = blend.blend_tiles(*args, gy, x["qw"], x["qi"], L * K)
    ref = blend.blend_tiles_plain(*args, x["qw"], x["qi"], L * K)
    rgb_only = blend.blend_tiles(*args, gy)
    rgb_ref = blend.blend_tiles_plain(*args)
    diffs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
    diffs.append(float((rgb_only[0] - rgb_ref[0]).abs().max()))
    errs["K2"] = max(diffs)
    log(f"K2 blend: max |kernel - plain| rgb/feat/T/rgb-only = {diffs} "
        f"(atol 3e-5); live entries {x['live']}, "
        f"max tile count {int(x['count'].max())}")
    if not errs["K2"] <= 3e-5:
        fail("K2 blend differs from its plain version")

    raw, nrm2 = query.query_map_tiles(out[1], x["phi"], x["gram"])
    raw_p, nrm2_p = query.query_map_tiles_plain(out[1], x["phi"], x["gram"])
    errs["K3"] = max(float((raw - raw_p).abs().max()),
                     float((nrm2 - nrm2_p).abs().max()))
    for a, b in ((raw, raw_p), (nrm2, nrm2_p)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    log(f"K3 query: max |kernel - plain| = {errs['K3']} (rtol/atol 1e-5)")
    torch.cuda.synchronize()
    return errs


def frame(model, settings, view, pm, clip, consts, dev, events=None):
    out = render(settings, model, view, pm, np.zeros(3, np.float32),
                 np.zeros(3, np.float32), quick_render=True, device=dev,
                 stage_events=events)
    relev = clip.relevancy_from_tiles(
        out.language_feature_weight_map, *consts, settings.grid_x,
        settings.grid_y, settings.image_height, settings.image_width,
        stage_events=events)
    return out, relev


def main_path(model, clip, consts, dev) -> dict:
    """Phase 4: budgets probed as bench.py does, then the counted frames."""
    plans = {}
    for name, h, w, probe in LOADS:
        view, pm, tfx, tfy = bench_camera(h, w)
        s = RasterizeSettings(h, w, tfx, tfy, 0, max_entries=probe,
                              assemble=False)
        out, _ = frame(model, s, view, pm, clip, consts, dev)
        tot, live = int(out.total_entries), int(out.live_total)
        if tot >= probe:
            fail(f"{name}: probe budget saturated ({tot} >= {probe})")
        budget = min(-(-int(tot * 1.07) // 4096) * 4096, probe)
        live_b = min(-(-int(live * 1.07) // 4096) * 4096, budget)
        plans[name] = (s._replace(max_entries=budget, live_entries=live_b),
                       view, pm)
        log(f"{name}: probe total {tot}, live {live} -> budgets "
            f"{budget} / {live_b}")
    torch.cuda.synchronize()

    for fn in WRAPPERS.values():
        fn.launches = 0
    results = {}
    for name, (s, view, pm) in plans.items():
        host_ms, stages = [], []
        for _ in range(FRAMES):
            events = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, relev = frame(model, s, view, pm, clip, consts, dev, events)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            stages.append({b[0]: a[1].elapsed_time(b[1])
                           for a, b in zip(events, events[1:])})
        tot, live = int(out.total_entries), int(out.live_total)
        wm = out.language_feature_weight_map
        n_tiles = s.grid_x * s.grid_y
        checks = {
            "total < max_entries": tot < s.max_entries,
            "live_total <= total": live <= tot,
            "live_total <= live_entries": live <= s.live_entries,
            "live_total > 0": live > 0,
            "map shape": tuple(wm.shape) == (n_tiles, 256, L * K),
            "relevancy shape": tuple(relev.shape) == (L, len(PROMPTS),
                                                      s.image_height,
                                                      s.image_width),
            "finite": all(bool(torch.isfinite(t).all()) for t in
                          (out.render, wm, out.final_transmittance, relev)),
            "relevancy in [0, 1]": bool(((relev >= 0) & (relev <= 1)).all()),
        }
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"{name}: checks failed: {bad}")
        stage_ms = {k: statistics.median(st[k] for st in stages)
                    for k in stages[0]}
        results[name] = dict(
            frame_ms_median=statistics.median(host_ms), frame_ms=host_ms,
            stage_ms_median=stage_ms, total_entries=tot, live_total=live,
            max_entries=s.max_entries, live_entries=s.live_entries,
            max_tile_count=int(out.max_tile_count))
        log(f"{name}: median frame {results[name]['frame_ms_median']:.3f} ms "
            f"over {FRAMES} frames; stages (median ms) "
            + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()))
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in WRAPPERS.items()}
    log(f"launches on the main path ({2 * FRAMES} frames): {launches}")
    if not all(v > 0 for v in launches.values()):
        fail(f"a kernel of the path was not launched: {launches}")
    return dict(loads=results, launches=launches, plans=plans)


def max_diff(pairs) -> float:
    return max(float((a - b).abs().max()) for a, b in pairs)


def kernels_at_main_shapes(model, clip, consts, plans, dev) -> dict:
    """Phase 5: at each load, every kernel (through its wrapper) on the
    main path's inputs, held against its plain version on the same inputs
    (K1 exact, K2 atol 3e-5, K3 rtol/atol 1e-5) and timed beside it, its
    bound for this run's data, and for K3 the einsum form."""
    rows = {}
    for name, (s, view, pm) in plans.items():
        x = stage_inputs(model, s, view, pm, consts, dev)
        gx, gy = s.grid_x, s.grid_y
        n = x["op"].shape[0]
        proj = x["proj"]
        n_on = int((proj.tiles_touched > 0).sum())
        offsets = torch.cumsum(proj.tiles_touched, 0, dtype=torch.int64) \
            - proj.tiles_touched
        r = {}
        k1 = lambda: expand.expand_entries(proj, x["op"], gx, gy,  # noqa: E731
                                           s.max_entries)
        k1_plain = lambda: expand.expand_entries_plain(  # noqa: E731
            proj, x["op"], offsets, gx, gy, s.max_entries, True,
            float(np.float32(255.0)))
        ms, out = cuda_ms(k1, 20)
        plain_ms, ref = cuda_ms(k1_plain, 3)
        pairs = list(zip(out[:3], ref))
        mismatch = sum(int((a != b).sum()) for a, b in pairs)
        r["K1"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                       max_abs_err=max_diff(pairs), mismatches=mismatch,
                       gaussians_on_screen=n_on,
                       off_screen_share=1.0 - n_on / n)
        r["K1"]["bound_ms"], r["K1"]["bound_by"] = bound(
            n * 12 + n_on * 44 + s.max_entries * 12,
            x["total"] * CULL_FLOPS)
        if mismatch:
            fail(f"{name}: K1 differs from its plain version in {mismatch} "
                 "outputs")
        del out, ref, pairs

        args = (x["g"], x["start"], x["count"], x["geom"], x["bg"], gx)
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        blend.blend_tiles(*args, gy, x["qw"], x["qi"], L * K, stats=stats)
        n_eval, n_inc = (int(v) for v in stats)
        k2 = lambda: blend.blend_tiles(*args, gy, x["qw"], x["qi"],  # noqa: E731
                                       L * K)
        k2_plain = lambda: blend.blend_tiles_plain(  # noqa: E731
            *args, x["qw"], x["qi"], L * K)
        ms, out = cuda_ms(k2, 10)
        plain_ms, ref = cuda_ms(k2_plain, 1)
        distinct = int(torch.unique(x["g"][:x["live"]]).numel())
        r["K2"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                       max_abs_err=max_diff(zip(out, ref)),
                       pairs_evaluated=n_eval, pairs_included=n_inc,
                       distinct_gaussians=distinct)
        n_tiles = gx * gy
        r["K2"]["bound_ms"], r["K2"]["bound_by"] = bound(
            x["live"] * 4 + n_tiles * 8 + distinct * (9 * 4 + L * TOPK * 8)
            + n_tiles * 256 * (3 + L * K + 1) * 4,
            n_eval * BLEND_ALPHA_FLOPS + n_inc * BLEND_INCLUDE_FLOPS)
        if not r["K2"]["max_abs_err"] <= 3e-5:
            fail(f"{name}: K2 differs from its plain version by "
                 f"{r['K2']['max_abs_err']} (atol 3e-5)")
        feat = out[1]
        del out, ref

        phi, gram = x["phi"], x["gram"]
        pq = phi.shape[2]
        k3 = lambda: query.query_map_tiles(feat, phi, gram)  # noqa: E731
        k3_plain = lambda: query.query_map_tiles_plain(  # noqa: E731
            feat, phi, gram)
        wm3 = feat.reshape(-1, L, K)

        def k3_einsum():
            torch.einsum("qlk,lkp->qlp", wm3, phi)
            torch.einsum("qlk,lkm,qlm->ql", wm3, gram, wm3)

        ms, out = cuda_ms(k3, 20)
        plain_ms, ref = cuda_ms(k3_plain, 5)
        q = n_tiles * 256
        flops = q * L * 2 * K * (K + pq + 1)
        r["K3"] = dict(ms=ms, plain_ms=plain_ms,
                       library_ms=cuda_ms(k3_einsum, 5)[0],
                       max_abs_err=max_diff(zip(out, ref)),
                       cuda_core_ops_ms=flops / F32_FLOPS * 1e3)
        r["K3"]["bound_ms"], r["K3"]["bound_by"] = bound(
            q * L * K * 4 + (L * K * pq + L * K * K) * 4 + q * L * (pq + 1) * 4,
            flops, F32_TENSOR_FLOPS)
        if not all(torch.allclose(a, b, rtol=1e-5, atol=1e-5)
                   for a, b in zip(out, ref)):
            fail(f"{name}: K3 differs from its plain version by "
                 f"{r['K3']['max_abs_err']} (rtol/atol 1e-5)")
        rows[name] = r
        for k, v in r.items():
            log(f"{name} {k}: " + ", ".join(
                f"{a} {b!r}" for a, b in v.items()))
        del x, feat, out, ref, wm3
        torch.cuda.empty_cache()
    return rows


def train_scene(n: int, seed: int, dev):
    """scripts/profile_train.py:38-48 (same draws in the same order) with
    create_from_pcd's other fields (identity rotations, SH degree-3 slots
    at active degree 0); logits and codebooks from a torch.Generator."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-4, 4, (n, 2)),
                          rng.uniform(2.0, 12.0, (n, 1))], 1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opacity = rng.uniform(-1, 2, (n, 1)).astype(np.float32)
    scaling = np.log(rng.uniform(0.004, 0.04, (n, 3))).astype(np.float32)
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1.0
    model = from_numpy_params(dict(
        xyz=pts, features_dc=((cols - 0.5) / 0.28209479177387814)[:, None, :],
        features_rest=np.zeros((n, 15, 3), np.float32), scaling=scaling,
        rotation=rot, opacity=opacity), active_sh_degree=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_language_features(model, 1, TRAIN_K, generator=gen), rng


def write_gt(rng, prefix: str, n_cams: int, h: int, w: int, cell: int = 48):
    """A TRAIN_S x 512 segment table and, per camera, a segment map of
    cell x cell blocks with ~5% of pixels at -1, as <name>_f.npy and
    <name>_s.npy (all 4 SAM levels alike) under GT_DIR."""
    os.makedirs(GT_DIR, exist_ok=True)
    table = rng.normal(size=(TRAIN_S, 512)).astype(np.float32)
    for i in range(n_cams):
        ids = rng.integers(0, TRAIN_S, (-(-h // cell), -(-w // cell)))
        seg = np.repeat(np.repeat(ids, cell, 0), cell, 1)[:h, :w]
        seg = seg.astype(np.int32)
        seg[rng.uniform(size=(h, w)) < 0.05] = -1
        np.save(os.path.join(GT_DIR, f"{prefix}{i}_s.npy"),
                np.broadcast_to(seg, (4, h, w)))
        np.save(os.path.join(GT_DIR, f"{prefix}{i}_f.npy"), table)


def train_cameras(prefix: str, yaws, h: int, w: int) -> list:
    fovy = math.radians(60)
    fovx = 2 * math.atan(math.tan(fovy / 2) * w / h)
    cams = []
    for i, deg in enumerate(yaws):
        t = math.radians(deg)
        R = np.array([[math.cos(t), 0, math.sin(t)], [0, 1, 0],
                      [-math.sin(t), 0, math.cos(t)]])
        cams.append(Camera(i, R, np.zeros(3), fovx, fovy, None,
                           f"{prefix}{i}", i, w, h))
    return cams


def train_step_inputs(model, cam, max_entries: int, live: int, dev) -> dict:
    """What the kernels of one training step get (the calls of
    render(include_feature=True) and the fused loss), for holding them
    against their plain versions and timing them alone."""
    s = make_settings(cam, 0, 1.0, max_entries, live_entries=live)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    gx, gy = s.grid_x, s.grid_y
    with torch.no_grad():
        qw, qi = model.get_weights_and_indices(TRAIN_TOPK)
        qw, qi = qw.contiguous(), qi.int().contiguous()
        op = model.get_opacity()[:, 0].contiguous()
        proj = projection.preprocess(
            model.xyz, model.get_scaling(), model.get_rotation(),
            model.get_features(), None, T(cam.world_view_transform),
            T(cam.full_proj_transform), T(cam.camera_center), s.tanfovx,
            s.tanfovy, s.image_width, s.image_height, 0, opacities=op)
        g, start, count, total, live_total = sorted_binning(s, proj, op)
        geom = blend.pack_gaussian_state(proj.xy, proj.conic, op, proj.rgb)
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        _, wmap, _ = blend.blend_tiles(g, start, count, geom,
                                       torch.zeros(3, device=dev), gx, gy, qw,
                                       qi, TRAIN_K, stats=stats)
        table, seg = cam.get_language_feature_compact(GT_DIR, 1)
        table, seg = T(table), T(seg)
        rhs, gfull = gram.prep(model.codebooks, table, 0)
    n_cov = int(count.sum())
    return dict(settings=s, g=g, start=start, count=count, geom=geom, qw=qw,
                qi=qi, wmap=wmap, table=table, seg=seg,
                seg_t=gram.seg_to_tiles(seg, gx, gy), rhs=rhs, gfull=gfull,
                total=int(total), live_total=int(live_total), covered=n_cov,
                n_eval=int(stats[0]), n_inc=int(stats[1]),
                distinct=int(torch.unique(g[:n_cov]).numel()),
                codebooks=model.codebooks.detach())


def normalized_err(a, b) -> tuple[float, float]:
    """(max |a - b|, the same over max |b|)."""
    err = float((a - b).abs().max())
    return err, err / max(float(b.abs().max()), 1e-30)


def check_train_kernels(x: dict, dev, timed: bool) -> dict:
    """K6a, K6b and K4 on one step's inputs against their plain versions
    (K6a per-tile sums rtol 1e-5 / atol 1e-4; K6b and K4 within 1e-4 and
    1e-5 of their largest output entry: atomics and sums of 256 terms in
    other orders), and the fused loss against the plain autograd of
    trainer._gram_cos_core (value rtol 1e-5, gradients 1e-4 of their
    largest entry). With `timed`, each kernel's time, its plain version's
    and its bound for this data."""
    s = x["settings"]
    gx, gy = s.grid_x, s.grid_y
    hw = s.image_height * s.image_width
    K, C = TRAIN_K, x["wmap"].shape[2]
    M = x["gfull"].shape[0]
    seg_t, wmap, rhs, gfull = x["seg_t"], x["wmap"], x["rhs"], x["gfull"]
    up = torch.ones((), device=dev)
    r = {}

    k6a = lambda: gram.gram_tiles_fwd(seg_t, wmap, rhs, gfull)  # noqa: E731
    k6a_plain = lambda: gram.gram_tiles_fwd_plain(  # noqa: E731
        seg_t, wmap, rhs, gfull, 1e-8)
    out, ref = k6a(), k6a_plain()
    err = normalized_err(out, ref)
    r["K6a"] = dict(max_abs_err=err[0], rel_err=err[1])
    if not torch.allclose(out, ref, rtol=1e-5, atol=1e-4):
        fail(f"K6a differs from its plain version by {err[0]}")

    k6b = lambda: gram.gram_tiles_bwd(  # noqa: E731
        seg_t, wmap, rhs, gfull, 0, K, 1e-8, 1.0 / hw, up)
    k6b_plain = lambda: gram.gram_tiles_bwd_plain(  # noqa: E731
        seg_t, wmap, rhs, gfull, 0, K, 1e-8, 1.0 / hw, up)
    out, ref = k6b(), k6b_plain()
    errs = [normalized_err(a, b) for a, b in zip(out, ref)]
    r["K6b"] = dict(max_abs_err=max(e[0] for e in errs),
                    rel_err=max(e[1] for e in errs))
    if not r["K6b"]["rel_err"] <= 1e-4:
        fail(f"K6b differs from its plain version: {errs}")
    cot = out[0]
    del out, ref

    args = (x["g"], x["start"], x["count"], x["geom"], cot)
    k4 = lambda: train.feature_grads(*args, gx, gy)  # noqa: E731
    k4_plain = lambda: train.feature_grads_plain(*args, gx)  # noqa: E731
    out, ref = k4(), k4_plain()
    err = normalized_err(out, ref)
    r["K4"] = dict(max_abs_err=err[0], rel_err=err[1])
    if not err[1] <= 1e-5:
        fail(f"K4 differs from its plain version by {err} (abs, relative)")
    del out, ref

    vals, grads = [], []
    for fn in (gram.gram_loss_fused, trainer.gram_cos_loss_tiles):
        cb = x["codebooks"].clone().requires_grad_(True)
        wm = wmap.clone().requires_grad_(True)
        loss = fn(cb, wm, x["table"], x["seg"], 0)
        loss.backward()
        vals.append(float(loss))
        grads.append((cb.grad, wm.grad))
    g_err = [normalized_err(a, b)[1] for a, b in zip(*grads)]
    r["loss_vs_xla_core"] = dict(fused=vals[0], xla=vals[1], grad_rel=g_err)
    if not (math.isclose(vals[0], vals[1], rel_tol=1e-5)
            and max(g_err) <= 1e-4):
        fail(f"the fused loss differs from the XLA formulation: "
             f"{r['loss_vs_xla_core']}")
    del grads
    if not timed:
        return r

    # Per pixel, the forward forms G w (2M^2), n2, num and the chain; the
    # backward reuses G w and adds d_w (4K), d_phi (2K) and d_G (2MK + K).
    # K4 needs only the entries the tiles cover: its g read and dF write
    # count x["covered"] rows, not the live budget's padding.
    q = x["seg_t"].numel()
    fwd_ops = q * (2 * M * M + 4 * M + 10)
    base_bytes = q * (M + 1) * 4 + rhs.numel() * 4 + gfull.numel() * 4
    for name, fn, plain, reps, nbytes, ops in (
            ("K6a", k6a, k6a_plain, 20, base_bytes + gx * gy * 4, fwd_ops),
            ("K6b", k6b, k6b_plain, 10,
             base_bytes + q * C * 4 + (rhs.shape[0] + M) * K * 4,
             fwd_ops + q * (7 * K + 2 * M * K)),
            ("K4", k4, k4_plain, 10,
             x["covered"] * 4 + gx * gy * 8 + x["distinct"] * 24
             + cot.numel() * 4 + x["covered"] * C * 4,
             x["n_eval"] * BLEND_ALPHA_FLOPS + x["n_inc"] * (3 + 2 * C))):
        r[name]["ms"] = cuda_ms(fn, reps)[0]
        r[name]["plain_ms"] = cuda_ms(plain, 1)[0]
        r[name]["library_ms"] = None
        r[name]["bound_ms"], r[name]["bound_by"] = bound(nbytes, ops,
                                                         F32_TENSOR_FLOPS)
    return r


def check_gram_wide(dev) -> dict:
    """K6a/K6b at the L=3 curriculum's last layer (M = 192, G read from
    device memory) on random inputs, against their plain versions."""
    gen = torch.Generator(device=dev).manual_seed(2)
    gx, gy, h, w, S = 30, 17, 272, 480, 256
    wm = torch.randn(gx * gy, 256, 3 * TRAIN_K, device=dev, generator=gen)
    seg = torch.randint(0, S, (h, w), device=dev, generator=gen,
                        dtype=torch.int32)
    seg[torch.rand(h, w, device=dev, generator=gen) < 0.05] = -1
    books = torch.randn(3, TRAIN_K, 512, device=dev, generator=gen)
    rhs, gfull = gram.prep(books, torch.randn(S, 512, device=dev,
                                              generator=gen), 2)
    seg_t = gram.seg_to_tiles(seg, gx, gy)
    a = gram.gram_tiles_fwd(seg_t, wm, rhs, gfull)
    b = gram.gram_tiles_fwd_plain(seg_t, wm, rhs, gfull, 1e-8)
    up = torch.ones((), device=dev)
    errs = [normalized_err(a, b)] + [
        normalized_err(u, v) for u, v in zip(
            gram.gram_tiles_bwd(seg_t, wm, rhs, gfull, 2, TRAIN_K, 1e-8,
                                1.0 / (h * w), up),
            gram.gram_tiles_bwd_plain(seg_t, wm, rhs, gfull, 2, TRAIN_K,
                                      1e-8, 1.0 / (h * w), up))]
    if not (torch.allclose(a, b, rtol=1e-5, atol=1e-4)
            and max(e[1] for e in errs[1:]) <= 1e-4):
        fail(f"K6 at M=192 differs from its plain version: {errs}")
    return dict(K6a=errs[0][0], K6b=max(e[0] for e in errs[1:]),
                rel=[e[1] for e in errs])


def train_checks_reduced(dev) -> dict:
    """Phase 6: the training kernels on a reduced scene (50k Gaussians,
    272x480, one camera) and K6 at M = 192."""
    model, rng = train_scene(50_000, 1, dev)
    write_gt(rng, "small", 1, 272, 480)
    cam = train_cameras("small", (0.0,), 272, 480)[0]
    x = train_step_inputs(model, cam, 1 << 20, 0, dev)
    r = check_train_kernels(x, dev, timed=False)
    r["wide"] = check_gram_wide(dev)
    for k in ("K4", "K6a", "K6b"):
        log(f"reduced {k}: max |kernel - plain| {r[k]['max_abs_err']!r} "
            f"({r[k]['rel_err']!r} of the largest)")
    log(f"reduced: fused loss vs XLA core {r['loss_vs_xla_core']}; "
        f"M=192 {r['wide']}")
    torch.cuda.synchronize()
    return r


def train_path(dev) -> dict:
    """Phase 7: train_features at full width, the launch counts of the
    run, then the kernels on one step's own inputs."""
    t0 = time.perf_counter()
    model, rng = train_scene(TRAIN_N, 0, dev)
    write_gt(rng, "cam", len(TRAIN_YAW_DEG), TRAIN_H, TRAIN_W)
    cams = train_cameras("cam", TRAIN_YAW_DEG, TRAIN_H, TRAIN_W)
    log(f"training scene: {TRAIN_N} Gaussians, {TRAIN_H}x{TRAIN_W}, L=1 "
        f"K={TRAIN_K} top-{TRAIN_TOPK}, {len(cams)} cameras, GT table "
        f"{TRAIN_S}x512 ({time.perf_counter() - t0:.1f} s)")
    opt = type("Opt", (), {"language_feature_lr": 0.0025})()
    max_entries = 2 ** 21
    step_ms, metrics_log = [], []
    clock = [None]

    def on_iteration(_it, _model, _opt, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - clock[0]) * 1e3)
        clock[0] = now
        metrics_log.append({k: float(v) for k, v in metrics.items()})

    torch.cuda.synchronize()
    for fn in TRAIN_WRAPPERS.values():
        fn.launches = 0
    clock[0] = time.perf_counter()
    model, optimizer, logs = trainer.train_features(
        model, cams, opt, GT_DIR, 1, iterations=TRAIN_ITERS, seed=0,
        max_entries=max_entries, feature_cache={}, on_iteration=on_iteration,
        device=dev)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in TRAIN_WRAPPERS.items()}
    losses = logs.losses
    budget = list(logs.live_budget.values())
    live = [int(m["live_total"]) for m in metrics_log]
    tot = [int(m["total_entries"]) for m in metrics_log]
    per_step = {k: v / TRAIN_ITERS for k, v in launches.items()}
    log(f"training: {TRAIN_ITERS} steps, median {statistics.median(step_ms):.3f}"
        f" ms a step (host clock + synchronize); loss first {losses[0]!r} "
        f"last {losses[-1]!r}; live_total {min(live)}..{max(live)} against "
        f"the live budget {budget}; total_entries {max(tot)} against "
        f"max_entries {max_entries}")
    log(f"launches on the training path ({TRAIN_ITERS} steps): {launches}; "
        f"per step {per_step}")
    if not all(v > 0 for v in launches.values()):
        fail(f"a kernel of the training path was not launched: {launches}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite training loss: {losses}")
    if not statistics.mean(losses[-4:]) < statistics.mean(losses[:4]):
        fail(f"the training loss did not fall: {losses}")
    if max(tot) >= max_entries or max(live) > max(budget):
        fail("the training run saturated its entry budgets")

    x = train_step_inputs(model, cams[0], max_entries, budget[0], dev)
    rows = check_train_kernels(x, dev, timed=True)
    # Stages of one step, each timed alone on the same inputs.
    s = x["settings"]._replace(assemble=False)
    c = cams[0]
    view, proj, campos = (c.world_view_transform, c.full_proj_transform,
                          c.camera_center)
    zero3 = np.zeros(3, np.float32)
    with torch.no_grad():
        fwd = lambda: render(s, model, view, proj, campos, zero3,  # noqa: E731
                             include_feature=True, topk=TRAIN_TOPK, device=dev)
        codes = lambda: model.get_weights_and_indices(TRAIN_TOPK)  # noqa: E731
        dfeat = train.feature_grads(x["g"], x["start"], x["count"], x["geom"],
                                    x["wmap"], s.grid_x, s.grid_y)
        red = lambda: train.reduce_to_gaussians(  # noqa: E731
            dfeat, x["g"], x["qi"])
        stages = {"render forward (preprocess, K1, sort, K2, top-k)":
                  cuda_ms(fwd, 5)[0],
                  "top-k codes (inside the forward)": cuda_ms(codes, 5)[0],
                  "K6a gram forward": rows["K6a"]["ms"],
                  "K6b gram backward": rows["K6b"]["ms"],
                  "K4 feature backward": rows["K4"]["ms"],
                  "projection + index_add_": cuda_ms(red, 5)[0],
                  "Adam step": cuda_ms(optimizer.step, 5)[0]}
    del dfeat
    for k, v in rows.items():
        log(f"training {k}: " + ", ".join(f"{a} {b!r}" for a, b in v.items()))
    log("training stages (ms, each alone): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    return dict(step_ms_median=statistics.median(step_ms), step_ms=step_ms,
                losses=losses, live_budget=budget, live_total=live,
                total_entries=tot, max_entries=max_entries,
                launches=launches, launches_per_step=per_step,
                kernels=rows, stage_ms=stages,
                step_entries=dict(total=x["total"], live=x["live_total"],
                                  pairs_evaluated=x["n_eval"],
                                  pairs_included=x["n_inc"],
                                  distinct_gaussians=x["distinct"]))


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device; this script runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {kind}, {torch.cuda.device_count()} visible")

    t0 = time.perf_counter()
    _, build_s = kernels.build()
    kernels.library()
    log(f"kernel build: {build_s:.1f} s ({time.perf_counter() - t0:.1f} s "
        "with load)")

    errs = check_kernels(dev)

    t0 = time.perf_counter()
    model = from_numpy_params(bench_scene(1_000_000), device=dev)
    clip = OpenCLIPNetwork("hash", device=dev)
    clip.set_positives(PROMPTS)
    consts = clip.prompt_constants(model.codebooks)
    log(f"scene: 1,000,000 Gaussians, {L}x{K}x{DIM} codebooks, "
        f"{L * TOPK} pairs ({time.perf_counter() - t0:.1f} s)")
    path = main_path(model, clip, consts, dev)
    timing = kernels_at_main_shapes(model, clip, consts, path.pop("plans"),
                                    dev)
    del model, clip, consts
    torch.cuda.empty_cache()

    train_errs = train_checks_reduced(dev)
    tpath = train_path(dev)

    line = []
    for k, (name, source, replaces) in KERNELS.items():
        if k in ("K1", "K2", "K3"):
            r = timing["1080p"][k]
            launches = path["launches"][k]
            err = max([errs[k]] + [t[k]["max_abs_err"]
                                   for t in timing.values()])
        else:
            r = tpath["kernels"][k]
            launches = tpath["launches"][k]
            err = max(r["max_abs_err"], train_errs[k]["max_abs_err"],
                      train_errs["wide"].get(k, 0.0))
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=err, ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    elapsed = time.perf_counter() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(gpu=smi, torch=torch.__version__,
                       cuda=torch.version.cuda, build_s=build_s,
                       elapsed_s=elapsed, max_abs_err_reduced=errs,
                       main_path=path, kernel_timing=timing,
                       train_reduced=train_errs, train_path=tpath), f,
                  indent=1)
    log(f"chip_smoke: {elapsed:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
