#!/usr/bin/env python3
"""K2 (langsplatv2_tpu_torch/csrc/blend.cu) on the card, mode by mode, at
1920x1080 on chip_smoke.py's bench scene (1M Gaussians, seed 0, the
probe budget).

    python3 profile_blend.py [--parent DIR] [--phases]

Each mode (f32 quick at 192 channels, rgb only, fast16 with bf16 tiles,
fast16 with bf16 cells, K2q, K2q with bf16 cells, dense at D = 192 and
D = 64) is timed through its wrapper (CUDA events, 10 launches after a
warm-up).
--parent DIR  a checkout of another commit (`git archive REV | tar -x -C
              DIR`): its csrc/blend.cu, whose C entry points must take
              this commit's arguments, is built into a second library,
              and each mode runs parent, this, this, parent.
--phases      csrc/blend.cu rebuilt with clock64 marks at its phase
              boundaries, read by thread 0 of each block: each phase's
              share of the blocks' cycles for the three-owner modes
              (prologue, (a) alpha, (b) the walk with the next batch's
              staging, (c) accumulate, the tile's write-out or query
              epilogue) and the batches a tile.
Prints the card's name and power limit first. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from langsplatv2_tpu_torch.eval.openclip import OpenCLIPNetwork
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.ops import blend, kernels
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings

OUT = Path("build") / "profile_blend"
BLEND_ENTRIES = ("lsv2_blend_tiles", "lsv2_blend_tiles_fast16",
                 "lsv2_blend_tiles_query", "lsv2_blend_tiles_dense")
# (anchor in csrc/blend.cu, mark inserted before it (False) or after it)
PHASE_MARKS = [
    ("  float T = 1.0f;\n", 0, False),
    ("    // (b) the transmittance walk", 1, False),
    ("    if (!all_done) stage_next(it, b0);\n", 2, True),
    ("    if (all_done) break;\n", 3, False),
]
PHASES = ["prologue", "(a) alpha", "(b) walk + staging", "(c) accumulate",
          "write-out / epilogue"]


def build_library(source: Path, name: str) -> ctypes.CDLL:
    """nvcc `source` (and csrc/errors.cu) into OUT/lib<name>.so, as
    kernels.build builds blend.cu, headers from its own directory first,
    then this commit's csrc; the blend entry points' argument types set."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    cmd = [kernels._nvcc(), *kernels.ARCH, *kernels.COMMON,
           *kernels.SOURCES["blend.cu"], f"-I{source.parent}",
           f"-I{kernels.CSRC}", "-shared", "-o", str(lib), str(source),
           str(kernels.CSRC / "errors.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"profile_blend: nvcc {source} failed\n{done.stdout}"
                 f"{done.stderr}")
    handle = ctypes.CDLL(str(lib.resolve()))
    for entry in BLEND_ENTRIES:
        fn = getattr(handle, entry)
        fn.argtypes = kernels.ENTRY_POINTS[entry]
        fn.restype = ctypes.c_int
    handle.lsv2_error_string.argtypes = [ctypes.c_int]
    handle.lsv2_error_string.restype = ctypes.c_char_p
    return handle


def marked_source() -> Path:
    """csrc/blend.cu with clock64 marks summed into a __device__ array per
    phase (see PHASE_MARKS), the batches in slot 6 and each block's total
    in slot 7, read and reset by k2_phases(out)."""
    src = (kernels.CSRC / "blend.cu").read_text()

    def insert(anchor, text, after):
        nonlocal src
        if src.count(anchor) != 1:
            sys.exit(f"profile_blend: phase anchor {anchor!r} not found once "
                     "in csrc/blend.cu")
        src = src.replace(anchor, anchor + text if after else text + anchor)

    insert("namespace {\n", "__device__ unsigned long long g_phase[8];\n",
           False)
    insert("  const int tile = kQA == 2 ? (int)(blockIdx.x >> 1) : "
           "(int)blockIdx.x;\n",
           "  long long t_prev = clock64(), t_begin = t_prev;\n"
           "  unsigned long long ph[8] = {};\n"
           "#define MARK(k) if (threadIdx.x == 0) { const long long t = "
           "clock64(); ph[k] += t - t_prev; t_prev = t; }\n", False)
    for anchor, k, after in PHASE_MARKS:
        mark = f"    MARK({k})\n" + ("    if (threadIdx.x == 0) ph[6] += 1;\n"
                                     if k == 3 else "")
        insert(anchor, mark, after)
    end = src.index("// Typed nulls")
    close = src.rindex("}\n", 0, end)
    src = (src[:close] + "  MARK(4)\n  if (threadIdx.x == 0) {\n"
           "    ph[7] = clock64() - t_begin;\n"
           "    for (int k = 0; k < 8; ++k) atomicAdd(&g_phase[k], ph[k]);\n"
           "  }\n" + src[close:])
    src += ('\nextern "C" int k2_phases(unsigned long long* out) {\n'
            "  const unsigned long long zero[8] = {};\n"
            "  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase, "
            "sizeof(zero));\n"
            "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, zero, "
            "sizeof(zero));\n"
            "  return (int)e;\n}\n")
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "blend_phases.cu"
    path.write_text(src)
    return path


def modes(dev) -> tuple[dict, int]:
    """Each K2 mode's wrapper call on the 1080p frame's own inputs, and
    the frame's tile count."""
    model = from_numpy_params(cs.bench_scene(1_000_000), device=dev)
    clip = OpenCLIPNetwork("hash", device=dev)
    clip.set_positives(cs.PROMPTS)
    phi, gram = clip.prompt_constants(model.codebooks)
    _name, h, w, probe = cs.LOADS[0]
    view, pm, tfx, tfy = cs.bench_camera(h, w)
    s = RasterizeSettings(h, w, tfx, tfy, 0, max_entries=probe,
                          assemble=False)
    gx, gy = s.grid_x, s.grid_y
    x = cs.stage_inputs(model, s, view, pm, (phi, gram), dev)
    f32 = (x["g"], x["start"], x["count"], x["geom"], x["bg"], gx)
    xf = cs.fast16_inputs(model, cs.bf16_variants(s)["exact"], view, pm,
                          dev)
    seg = (xf["g"], xf["start"], xf["count"], xf["rows"], xf["bg"], gx, gy)
    xd = cs.dense_inputs(model, s, view, pm, np.zeros(3, np.float32), dev)
    feats = torch.zeros(model.xyz.shape[0], cs.L * cs.K, device=dev)
    feats.scatter_add_(1, model.quick_indices.long(), model.quick_weights)
    f64 = feats[:, :64].contiguous()
    dense = (xd["g"], xd["start"], xd["count"], xd["geom"])
    lk, pairs = cs.L * cs.K, cs.L * cs.TOPK
    return {
        "f32": lambda: blend.blend_tiles(*f32, gy, x["qw"], x["qi"], lk),
        "rgb": lambda: blend.blend_tiles(*f32, gy),
        "fast16": lambda: blend.blend_tiles_fast16(*seg, pairs, lk, True),
        "fast16 cells": lambda: blend.blend_tiles_fast16(
            *seg, pairs, lk, True, cells_bf16=True),
        "K2q": lambda: blend.blend_tiles_query(*seg, pairs, phi, gram),
        "K2q cells": lambda: blend.blend_tiles_query(
            *seg, pairs, phi, gram, cells_bf16=True),
        "dense 192": lambda: blend.blend_tiles_dense(*dense, feats, xd["bg"],
                                                     gx, gy),
        "dense 64": lambda: blend.blend_tiles_dense(*dense, f64, xd["bg"],
                                                    gx, gy),
    }, gx * gy


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_blend: no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    this = kernels.library()
    parent = (build_library(args.parent / "langsplatv2_tpu_torch" / "csrc"
                            / "blend.cu", "blend_parent")
              if args.parent else None)
    marked = build_library(marked_source(), "blend_phases") \
        if args.phases else None
    if marked is not None:
        marked.k2_phases.argtypes = [ctypes.c_void_p]
    calls, n_tiles = modes(dev)
    for name, fn in calls.items():
        times = {}
        for side, lib in (("parent", parent), ("this", this), ("this", this),
                          ("parent", parent)):
            if lib is None:
                continue
            kernels._library = lib
            times.setdefault(side, []).append(cs.cuda_ms(fn, 10)[0])
        kernels._library = this
        print(f"{name}: " + "; ".join(f"{k} {v} ms" for k, v in
                                      times.items()), flush=True)
        if marked is None:
            continue
        kernels._library = marked
        buf = (ctypes.c_ulonglong * 8)()
        for _ in range(2):   # the first read drops the warm-up's counts
            fn()
            torch.cuda.synchronize()
            marked.k2_phases(ctypes.cast(buf, ctypes.c_void_p))
        kernels._library = this
        total = buf[7]
        if buf[6] == 0:   # a one-owner mode: no phase marks on its path
            print(f"  {name}: one thread a pixel, {total / n_tiles:.0f} "
                  "cycles a tile", flush=True)
            continue
        print(f"  {name} phases: " + ", ".join(
            f"{PHASES[k]} {buf[k] / total:.3f}" for k in range(5))
            + f"; {buf[6] / n_tiles:.2f} batches a tile, "
            f"{total / n_tiles:.0f} cycles a tile", flush=True)


if __name__ == "__main__":
    main()
