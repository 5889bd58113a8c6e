#!/usr/bin/env python3
"""K3 (langsplatv2_tpu_torch/csrc/query.cu), K6a and K6b (csrc/gram.cu) on
the card, at the shapes of the main paths.

    python3 profile_query_gram.py [--parent DIR] [--phases]

Each case is timed through its wrapper (CUDA events, 20 launches after a
warm-up): K3 on the f32 and the bf16 (fast16) map of chip_smoke.py's 1080p
frame (1M Gaussians, seed 0, 3 levels, 1 + 4 prompts, and 13 + 4: the
general design, which has no phase marks), K6a and K6b at
M = 64 on one step of chip_smoke.py's training slice (300k Gaussians,
544x960) and at M = 192 on check_gram_wide's random inputs (272x480, 256
segments), K6a also at M = 256 (gram_wide_inputs of four layers).
--parent DIR  a checkout of another commit (`git archive REV | tar -x -C
              DIR`): its csrc/query.cu and csrc/gram.cu are built into a
              second library and each case runs parent, this, this, parent
              (a parent whose Gram kernels have the entry points
              lsv2_gram_fwd and lsv2_gram_bwd is called through them).
--phases      query.cu and gram.cu rebuilt with -DLSV2_PHASES
              (csrc/phase_marks.cuh): clock64 of thread 0 of each block,
              each phase's share of its cycles. K3: the B stage, waiting for
              a level's loads, the products, the epilogue (nrm2 shuffles and
              the stores), and cycles a 16-pixel level. K6a: prologue,
              waiting for the chunk's stage, (1) W.G + chain + sim, the
              chunk's sum with its barrier; K6b: prologue, waiting for the
              chunk's stage, (1) W.G + chain + d_w, barriers, (2) d_phi,
              (3) d_G, the d_G flush; both in cycles a 128-pixel chunk.
Prints the card's name and power limit first, then, for this commit's
library and the parent's, each K3, K6a and K6b instantiation's SASS
instructions and tensor-core (HMMA) instructions (cuobjdump, where the
toolkit has it). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from langsplatv2_tpu_torch.eval.openclip import OpenCLIPNetwork
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.ops import blend, gram, kernels, query
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings

OUT = Path("build") / "profile_query_gram"
SOURCES = ("query.cu", "gram.cu")
ENTRIES = ("lsv2_query_map_tiles", "lsv2_query_map_tiles_bf16",
           "lsv2_gram")
K3_PHASES = ["B stage", "load wait", "products", "epilogue"]
K6A_PHASES = ["prologue", "stage wait", "(1) W.G + chain + sim",
              "chunk sum + barrier"]
K6B_PHASES = ["prologue", "stage wait", "(1) W.G + chain + d_w", "barriers",
              "(2) d_phi", "(3) d_G", "d_G flush"]
# The Gram entry points before lsv2_gram: (seg w rhs gfull num_tiles C M
# eps partial stream) and (seg w rhs gfull num_tiles C M K lay eps inv_hw
# upstream dw dphi dg [gsplit] stream).
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_GRAM = {"lsv2_gram_fwd": [_P] * 4 + [_I] * 3 + [_F] + [_P] * 2,
            "lsv2_gram_bwd": [_P] * 4 + [_I] * 5 + [_F] * 2 + [_P] * 6}


class _OldGram:
    """A library with the older Gram entry points: lsv2_gram's one-pass
    calls (the shapes those took) go to lsv2_gram_fwd / lsv2_gram_bwd, the
    scratch pointer dropped where the backward takes none."""

    def __init__(self, handle, bwd_scratch: bool):
        self._handle = handle
        self._scratch = bwd_scratch

    def __getattr__(self, name):
        return getattr(self._handle, name)

    def lsv2_gram(self, bwd, _kpk, _any, seg, w, rhs, gfull, t, c, widths,
                  eps, inv_hw, upstream, out, dphi, dg, gsplit, stream):
        m, k = ctypes.cast(widths, ctypes.POINTER(ctypes.c_int))[0:2]
        if not bwd:
            return self._handle.lsv2_gram_fwd(seg, w, rhs, gfull, t, c, m,
                                              eps, out, stream)
        tail = (gsplit, stream) if self._scratch else (stream,)
        return self._handle.lsv2_gram_bwd(seg, w, rhs, gfull, t, c, m, k,
                                          m // k - 1, eps, inv_hw, upstream,
                                          out, dphi, dg, *tail)


def build_library(csrc: Path, name: str, extra=()):
    """nvcc csrc's query.cu and gram.cu (and this commit's errors.cu) into
    OUT/lib<name>.so with this commit's flags, headers from csrc first; the
    entry points' argument types set."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    cmd = [kernels._nvcc(), *kernels.ARCH, *kernels.COMMON, *extra,
           f"-I{csrc}", "-shared", "-o", str(lib),
           *(str(csrc / s) for s in SOURCES),
           str(kernels.CSRC / "errors.cu")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"profile_query_gram: nvcc in {csrc} failed\n{done.stdout}"
                 f"{done.stderr}")
    handle = ctypes.CDLL(str(lib.resolve()))
    gram_src = (csrc / "gram.cu").read_text()
    old = "lsv2_gram(" not in gram_src
    entries = ENTRIES[:2] + (tuple(OLD_GRAM) if old else ENTRIES[2:])
    for entry in entries:
        fn = getattr(handle, entry)
        types = list(OLD_GRAM.get(entry, kernels.ENTRY_POINTS.get(entry, [])))
        if entry == "lsv2_gram_bwd" and "gsplit" not in gram_src:
            del types[15]
        fn.argtypes = types
        fn.restype = ctypes.c_int
    handle.lsv2_error_string.argtypes = [ctypes.c_int]
    handle.lsv2_error_string.restype = ctypes.c_char_p
    return _OldGram(handle, "gsplit" in gram_src) if old else handle


def query_cases(dev) -> dict:
    """K3's wrapper calls on the 1080p frame's f32 and bf16 maps, with the
    main path's prompts (PQ = 5) and chip_smoke.py's 13 positives (PQ =
    17, the general design)."""
    model = from_numpy_params(cs.bench_scene(1_000_000), device=dev)
    clip = OpenCLIPNetwork("hash", device=dev)
    clip.set_positives(cs.PROMPTS)
    phi, gm = clip.prompt_constants(model.codebooks)
    clip.set_positives(cs.MANY_POSITIVES)
    phi17, gm17 = clip.prompt_constants(model.codebooks)
    _name, h, w, probe = cs.LOADS[0]
    view, pm, tfx, tfy = cs.bench_camera(h, w)
    s = RasterizeSettings(h, w, tfx, tfy, 0, max_entries=probe,
                          assemble=False)
    gx, gy = s.grid_x, s.grid_y
    with torch.no_grad():
        x = cs.stage_inputs(model, s, view, pm, (phi, gm), dev)
        feat32 = blend.blend_tiles(x["g"], x["start"], x["count"], x["geom"],
                                   x["bg"], gx, gy, x["qw"], x["qi"],
                                   cs.L * cs.K)[1]
        del x
        xf = cs.fast16_inputs(model, cs.bf16_variants(s)["exact"], view, pm,
                              dev)
        feat16 = blend.blend_tiles_fast16(
            xf["g"], xf["start"], xf["count"], xf["rows"], xf["bg"], gx, gy,
            cs.L * cs.TOPK, cs.L * cs.K, True)[1]
        del xf
    torch.cuda.empty_cache()
    return {"K3 f32 1080p": lambda: query.query_map_tiles(feat32, phi, gm),
            "K3 bf16 1080p": lambda: query.query_map_tiles_bf16(feat16, phi,
                                                                gm),
            "K3 f32 1080p PQ=17": lambda: query.query_map_tiles(
                feat32, phi17, gm17),
            "K3 bf16 1080p PQ=17": lambda: query.query_map_tiles_bf16(
                feat16, phi17, gm17)}


def gram_cases(dev) -> dict:
    """K6a's and K6b's wrapper calls: one training step's inputs (M = 64),
    check_gram_wide's (M = 192) and K6a on gram_wide_inputs of four layers
    (M = 256)."""
    model, rng = cs.train_scene(cs.TRAIN_N, 0, dev)
    cs.write_gt(rng, "prof", 1, cs.TRAIN_H, cs.TRAIN_W)
    cam = cs.train_cameras("prof", (cs.TRAIN_YAW_DEG[0],), cs.TRAIN_H,
                           cs.TRAIN_W)[0]
    x = cs.train_step_inputs(model, cam, 2 ** 21, 0, dev)
    hw = cs.TRAIN_H * cs.TRAIN_W
    up = torch.ones((), device=dev)
    m64 = (x["seg_t"], x["wmap"], x["rhs"], x["gfull"])
    *m192, hw192 = cs.gram_wide_inputs(dev, 3)
    *m256, _ = cs.gram_wide_inputs(dev, 4)
    return {
        "K6a M=64 544x960": lambda: gram.gram_tiles_fwd(*m64),
        "K6a M=192 272x480": lambda: gram.gram_tiles_fwd(*m192),
        "K6a M=256 272x480": lambda: gram.gram_tiles_fwd(*m256),
        "K6b M=64 544x960": lambda: gram.gram_tiles_bwd(
            *m64, 0, cs.TRAIN_K, 1e-8, 1.0 / hw, up),
        "K6b M=192 272x480": lambda: gram.gram_tiles_bwd(
            *m192, 2, cs.TRAIN_K, 1e-8, 1.0 / hw192, up)}


KERNEL_NAME = re.compile(r"(query_any_kernel|query_kernel|gram_kernel|"
                         r"gram_fwd_kernel|gram_bwd_kernel)(I.*?EE)?")


def sass_mma_counts(lib: Path) -> dict:
    """{kernel: (SASS instructions, {HMMA opcode: count})} for K3's, K6a's
    and K6b's instantiations in `lib` (mangled name and template
    arguments); empty without cuobjdump."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = KERNEL_NAME.search(line.split("Function :")[1])
            fn = m.group(1) + (m.group(2) or "") if m else None
            if fn:
                counts[fn] = [0, collections.Counter()]
            continue
        if fn is None or "/*" not in line or ";" not in line:
            continue
        words = line.split("*/", 1)[1].split()
        op = words[1] if words[0].startswith("@") else words[0]
        counts[fn][0] += 1
        if op.startswith("HMMA"):
            counts[fn][1][op.rstrip(";")] += 1
    return {k: (n, dict(c)) for k, (n, c) in counts.items()}


def phase_line(lib, name: str, fn) -> str:
    """Run fn twice on the phase library (the first read drops the
    warm-up's counts) and format thread 0's phase shares."""
    readout = (lib.lsv2_query_phases if name.startswith("K3")
               else lib.lsv2_gram_phases)
    labels, unit = {"K3": (K3_PHASES, "16-pixel level"),
                    "K6a": (K6A_PHASES, "128-pixel chunk"),
                    "K6b": (K6B_PHASES, "128-pixel chunk")}[name.split()[0]]
    buf = (ctypes.c_ulonglong * 16)()
    kernels._library = lib
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        readout(ctypes.cast(buf, ctypes.c_void_p))
    total = buf[15]
    return (f"  {name} phases: " + ", ".join(
        f"{lab} {buf[k] / total:.3f}" for k, lab in enumerate(labels))
        + f"; {total / max(buf[14], 1):.0f} cycles a {unit} (thread 0)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_query_gram: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    this = kernels.library()
    for name, (n, mma) in sass_mma_counts(kernels.build()[0]).items():
        print(f"SASS {name}: {n} instructions, tensor-core {mma}",
              flush=True)
    parent = (build_library(args.parent / "langsplatv2_tpu_torch" / "csrc",
                            "parent") if args.parent else None)
    if parent is not None:
        for name, (n, mma) in sass_mma_counts(OUT / "libparent.so").items():
            print(f"SASS parent {name}: {n} instructions, tensor-core {mma}",
                  flush=True)
    marked = (build_library(kernels.CSRC, "phases", ["-DLSV2_PHASES"])
              if args.phases else None)
    if marked is not None:
        for fn in ("lsv2_query_phases", "lsv2_gram_phases"):
            getattr(marked, fn).argtypes = [ctypes.c_void_p]
    calls = {**query_cases(dev), **gram_cases(dev)}
    for name, fn in calls.items():
        times = {}
        for side, lib in (("parent", parent), ("this", this), ("this", this),
                          ("parent", parent)):
            if lib is None:
                continue
            kernels._library = lib
            try:
                times.setdefault(side, []).append(cs.cuda_ms(fn, 20)[0])
            except (RuntimeError, AttributeError) as err:
                if side != "parent":
                    raise
                # A shape the parent's kernels refuse (a launch's shared
                # memory past the card's, or no entry point): no time.
                torch.cuda.synchronize()
                times[side] = [f"refused: {err}"]
        kernels._library = this
        print(f"{name}: " + "; ".join(f"{k} {v} ms" for k, v in
                                      times.items()), flush=True)
        if marked is not None and "PQ=17" not in name:
            print(phase_line(marked, name, fn), flush=True)
            kernels._library = this


if __name__ == "__main__":
    main()
