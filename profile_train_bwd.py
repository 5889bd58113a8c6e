#!/usr/bin/env python3
"""K4 (langsplatv2_tpu_torch/csrc/feature_bwd.cu), K5
(csrc/feature_bwd_topk.cu) and K7 (csrc/rgb_bwd.cu) on the card, at the
shapes of the training paths.

    python3 profile_train_bwd.py [--parent DIR] [--phases]

Each case is timed through its wrapper (CUDA events, 20 launches after a
warm-up): K4 at C = 64 on one step of chip_smoke.py's feature slice
(300k Gaussians, 544x960, L = 1, K = 64, top-4, at the live budget the
trainer sets; the cotangent is that step's K6b d_w) and at C = 192 on the same step's blend with a seeded
[T, 256, 192] cotangent, K5 on one step of chip_smoke.py's capped
feature slice (phase 11: the same scene and camera, tile budget 1e-6,
cap 128, top-4, C = 64; the cotangent is that step's K6b d_w), and K7 on
one step of chip_smoke.py's geometry slice (300k Gaussians, 544x960, SH
3, the first camera; the loss's own cotangents).
--parent DIR  a checkout of another commit (`git archive REV | tar -x -C
              DIR`): its csrc/feature_bwd.cu, csrc/feature_bwd_topk.cu and
              csrc/rgb_bwd.cu are built into a second library and each
              case runs parent, this, this, parent.
--phases      the sources rebuilt with -DLSV2_PHASES
              (csrc/phase_marks.cuh): clock64 of thread 0 of each block,
              each phase's share of its cycles. K4: staging wait, replay,
              product, cross-warp sum, writes; K5: staging wait, replay,
              products and reductions, cross-warp sum and writes; K7:
              staging wait, chain, reductions, writes; and the cycles a
              batch (thread 0).
Prints the card's name and power limit first, then, for this commit's
library and the parent's, K4's, K5's and K7's SASS instructions,
tensor-core (HMMA) and shuffle (SHFL) instructions (cuobjdump, where the
toolkit has it). The SHFL count is static: K5's reductions sit in a loop
over the batches (and, in this commit, over topk). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from langsplatv2_tpu_torch.ops import gram, kernels, rgb_train, train

OUT = Path("build") / "profile_train_bwd"
SOURCES = ("feature_bwd.cu", "feature_bwd_topk.cu", "rgb_bwd.cu")
ENTRIES = ("lsv2_feature_bwd", "lsv2_feature_bwd_topk", "lsv2_rgb_bwd")
PHASES = {"K4": ("lsv2_feature_bwd_phases",
                 ["staging wait", "replay", "product", "cross-warp sum",
                  "writes"]),
          "K5": ("lsv2_feature_bwd_topk_phases",
                 ["staging wait", "replay", "products and reductions",
                  "cross-warp sum and writes"]),
          "K7": ("lsv2_rgb_bwd_phases",
                 ["staging wait", "chain", "reductions", "writes"])}
KERNEL_NAMES = {"K4": "feature_bwd_kernel",
                "K5": "feature_bwd_topk_kernel", "K7": "rgb_bwd_kernel"}


def build_library(csrc: Path, name: str, extra=()):
    """nvcc csrc's SOURCES (each with this commit's flags for it) and this
    commit's errors.cu into OUT/lib<name>.so; the entry points' argument
    types set."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    objs, procs = [], []
    for src in (*(csrc / s for s in SOURCES), kernels.CSRC / "errors.cu"):
        obj = OUT / f"{name}.{src.stem}.o"
        cmd = [kernels._nvcc(), *kernels.ARCH, *kernels.COMMON,
               *kernels.SOURCES[src.name], *extra, "-c", str(src), "-o",
               str(obj)]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
        objs.append(str(obj))
    for src, proc in zip(SOURCES + ("errors.cu",), procs):
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"profile_train_bwd: nvcc {csrc / src} failed\n{out}")
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name} {src}: {line.strip()}", flush=True)
    done = subprocess.run([kernels._nvcc(), *kernels.ARCH, "-shared", "-o",
                           str(lib), *objs], capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"profile_train_bwd: link failed\n{done.stdout}")
    handle = ctypes.CDLL(str(lib.resolve()))
    for entry in ENTRIES:
        fn = getattr(handle, entry)
        fn.argtypes = kernels.ENTRY_POINTS[entry]
        fn.restype = ctypes.c_int
    handle.lsv2_error_string.argtypes = [ctypes.c_int]
    handle.lsv2_error_string.restype = ctypes.c_char_p
    return handle, lib


def feature_cases(dev) -> dict:
    """K4's wrapper calls on one feature step: the step's own cotangent
    (K6b's d_w, C = 64) and a seeded C = 192 one on the same blend."""
    model, rng = cs.train_scene(cs.TRAIN_N, 0, dev)
    cs.write_gt(rng, "prof", 1, cs.TRAIN_H, cs.TRAIN_W)
    cam = cs.train_cameras("prof", (cs.TRAIN_YAW_DEG[0],), cs.TRAIN_H,
                           cs.TRAIN_W)[0]
    # The step's live budget as train_features sets it after its first step
    # (chip_smoke.py phase 7 times K4 at the same budget): dF has that many
    # rows, the tail past the covered entries zeroed.
    x = cs.train_step_inputs(model, cam, 2 ** 21, 0, dev)
    budget = min(2 ** 21, -(-int(x["live_total"] * 1.3 + 32768) // 65536)
                 * 65536)
    x = cs.train_step_inputs(model, cam, 2 ** 21, budget, dev)
    s = x["settings"]
    gx, gy = s.grid_x, s.grid_y
    hw = cs.TRAIN_H * cs.TRAIN_W
    up = torch.ones((), device=dev)
    cot64 = gram.gram_tiles_bwd(x["seg_t"], x["wmap"], x["rhs"], x["gfull"],
                                0, cs.TRAIN_K, 1e-8, 1.0 / hw, up)[0]
    gen = torch.Generator(device=dev).manual_seed(3)
    cot192 = torch.randn(gx * gy, 256, 192, device=dev, generator=gen)
    args = (x["g"], x["start"], x["count"], x["geom"])
    print(f"feature step: {x['covered']} covered entries of "
          f"{x['g'].shape[0]}, {x['n_eval']} evaluated and {x['n_inc']} "
          f"included pairs, {gx * gy} tiles", flush=True)
    return {"K4 C=64 544x960": lambda: train.feature_grads(
                *args, cot64, gx, gy),
            "K4 C=192 544x960": lambda: train.feature_grads(
                *args, cot192, gx, gy)}


def capped_cases(dev) -> dict:
    """K5's wrapper call on one capped feature step (chip_smoke.py phase
    11's scene, first camera, its settings)."""
    model, rng = cs.train_scene(cs.TRAIN_N, 0, dev)
    cs.write_gt(rng, "prof_cap", 1, cs.TRAIN_H, cs.TRAIN_W)
    cam = cs.train_cameras("prof_cap", (cs.TRAIN_YAW_DEG[0],), cs.TRAIN_H,
                           cs.TRAIN_W)[0]
    x = cs.capped_step_inputs(model, cam, 2 ** 21, dev)
    s = x["settings"]
    args = (x["g"], x["kept"], x["geom"], x["qi"], x["cot"])
    print(f"capped feature step: {x['kept_total']} kept entries in "
          f"{s.grid_x * s.grid_y} windows of {s.tile_budget_cap}, "
          f"{x['n_eval']} evaluated and {x['n_inc']} included pairs",
          flush=True)
    return {"K5 topk=4 C=64 544x960": lambda: train.feature_grads_topk(
        *args, s.grid_x, s.grid_y, s.tile_budget_cap)}


def rgb_cases(dev) -> dict:
    """K7's wrapper call on one geometry step (the first camera)."""
    model, images = cs.rgb_scene(cs.RGB_N, cs.TRAIN_H, cs.TRAIN_W, 1, 0, dev)
    cam = cs.train_cameras("prof_rgb", (cs.TRAIN_YAW_DEG[0],), cs.TRAIN_H,
                           cs.TRAIN_W, images)[0]
    x = cs.rgb_step_inputs(model, cam, 2 ** 21, dev)
    s = x["settings"]
    args = (x["g"], x["start"], x["count"], x["geom"], x["pack"])
    print(f"geometry step: {x['covered']} covered entries, {x['n_eval']} "
          f"evaluated and {x['n_inc']} included pairs", flush=True)
    return {"K7 544x960 SH 3": lambda: rgb_train.rgb_grads(
        *args, s.grid_x, s.grid_y)}


def sass_counts(lib: Path) -> dict:
    """{K4 / K5 / K7: (SASS instructions, {HMMA / SHFL opcode: count})}
    for the kernels in `lib`; empty without cuobjdump."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = next((k for k, v in KERNEL_NAMES.items() if v in name),
                      None)
            if fn:
                fn = f"{fn} {name}"
                counts[fn] = [0, collections.Counter()]
            continue
        if fn is None or "/*" not in line or ";" not in line:
            continue
        words = line.split("*/", 1)[1].split()
        op = words[1] if words[0].startswith("@") else words[0]
        counts[fn][0] += 1
        if op.startswith(("HMMA", "SHFL")):
            counts[fn][1][op.rstrip(";")] += 1
    return {k: (n, dict(c)) for k, (n, c) in counts.items()}


def phase_line(lib, name: str, fn) -> str:
    """Run fn twice on the phase library (the first read drops the
    warm-up's counts) and format thread 0's phase shares."""
    readout, labels = PHASES[name.split()[0]]
    readout = getattr(lib, readout)
    buf = (ctypes.c_ulonglong * 16)()
    kernels._library = lib
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        readout(ctypes.cast(buf, ctypes.c_void_p))
    total = buf[15]
    return (f"  {name} phases: " + ", ".join(
        f"{lab} {buf[k] / total:.3f}" for k, lab in enumerate(labels))
        + f"; {total / max(buf[14], 1):.0f} cycles a batch (thread 0)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_train_bwd: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    this = kernels.library()
    libs = {"this": kernels.build()[0]}
    parent = None
    if args.parent:
        parent, libs["parent"] = build_library(
            args.parent / "langsplatv2_tpu_torch" / "csrc", "parent")
    for side, path in libs.items():
        for name, (n, ops) in sass_counts(path).items():
            print(f"SASS {side} {name}: {n} instructions, {ops}", flush=True)
    marked = None
    if args.phases:
        marked = build_library(kernels.CSRC, "phases", ["-DLSV2_PHASES"])[0]
        for readout, _ in PHASES.values():
            getattr(marked, readout).argtypes = [ctypes.c_void_p]
    calls = {**feature_cases(dev), **capped_cases(dev), **rgb_cases(dev)}
    for name, fn in calls.items():
        times = {}
        for side, lib in (("parent", parent), ("this", this), ("this", this),
                          ("parent", parent)):
            if lib is None:
                continue
            kernels._library = lib
            times.setdefault(side, []).append(cs.cuda_ms(fn, 20)[0])
        kernels._library = this
        print(f"{name}: " + "; ".join(f"{k} {v} ms" for k, v in
                                      times.items()), flush=True)
        if marked is not None:
            print(phase_line(marked, name, fn), flush=True)
            kernels._library = this


if __name__ == "__main__":
    main()
