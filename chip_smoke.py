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
   einsum form.
It prints the kernels line (max_abs_err: the largest of phases 3 and 5)
and, last, {"ok": true, "device": {...}}.
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
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.models.renderer import render
from langsplatv2_tpu_torch.ops import blend, expand, kernels, projection, query
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings, \
    sorted_binning
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
}
WRAPPERS = {"K1": expand.expand_entries, "K2": blend.blend_tiles,
            "K3": query.query_map_tiles}


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

    line = []
    for k, (name, source, replaces) in KERNELS.items():
        r = timing["1080p"][k]
        err = max([errs[k]] + [t[k]["max_abs_err"] for t in timing.values()])
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=path["launches"][k], max_abs_err=err, ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    elapsed = time.perf_counter() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(gpu=smi, torch=torch.__version__,
                       cuda=torch.version.cuda, build_s=build_s,
                       elapsed_s=elapsed, max_abs_err_reduced=errs,
                       main_path=path, kernel_timing=timing), f, indent=1)
    log(f"chip_smoke: {elapsed:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
