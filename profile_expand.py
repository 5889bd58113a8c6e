#!/usr/bin/env python3
"""K1 (langsplatv2_tpu_torch/csrc/expand.cu) on the card, in both its modes,
through its wrapper `ops/expand.py::expand_entries`.

    python3 profile_expand.py [--parent DIR] [--phases]

Cases, each timed through the wrapper (CUDA events, 20 calls after a
warm-up), without and with with_alpha = 2 (the round-4 chain's sub-box
bounds):
- "1080p": chip_smoke.py phase 5's inputs, the bench scene (1,000,000
  Gaussians) preprocessed at 1920x1080, max_entries the probed total plus
  7% rounded up to 4096, as phase 4 sets it;
- "whole grid": chip_smoke.py phase 20's K1 edge shapes (`wide_expand_case`:
  a 120 x 68 tile grid, 16 rects over all 8,160 tiles among 100,000
  Gaussians, runs of zero-tile ones), with a tail past the total.
--parent DIR  a checkout of another commit (`git archive REV | tar -x -C
              DIR`): its package is copied under build/profile_expand as
              `lsv2_parent`, its csrc/expand.cu is built into a second
              library, and each case runs the parent's wrapper and this
              one in turns (parent, this, this, parent). Both must give
              the same entries (checked once a case).
--phases      this commit's expand.cu rebuilt with -DLSV2_PHASES
              (csrc/phase_marks.cuh): thread 0 of each block, each phase's
              share of its cycles (dead slots, owner search, staging,
              entries with their sub-box bounds) and the cycles a staging
              pass.
Prints the card's name and power limit first, and for each case and side
the device launches one wrapper call makes and their device time
(torch.profiler: kernels and memsets; the wrapper's event time also holds
whatever the host leaves the device idle). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from langsplatv2_tpu_torch.ops import expand, kernels, projection

OUT = Path("build") / "profile_expand"
PHASE_LABELS = ["dead slots", "owner search", "staging",
                "entries (with their sub-box bounds)"]
SUBDIV = cs.CAPPED["subdiv"]


def build_library(csrc: Path, name: str, flags, entries: dict,
                  extra=()):
    """nvcc csrc/expand.cu (with `flags`) and this commit's errors.cu into
    OUT/lib<name>.so, with the argument types of `entries` set."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    objs, procs = [], []
    for src, fl in ((csrc / "expand.cu", flags),
                    (kernels.CSRC / "errors.cu", [])):
        obj = OUT / f"{name}.{src.stem}.o"
        cmd = [kernels._nvcc(), *kernels.ARCH, *kernels.COMMON, *fl, *extra,
               "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
        objs.append(str(obj))
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"profile_expand: nvcc {src} failed\n{out}")
    done = subprocess.run([kernels._nvcc(), *kernels.ARCH, "-shared", "-o",
                           str(lib), *objs], capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"profile_expand: link failed\n{done.stdout}")
    handle = ctypes.CDLL(str(lib.resolve()))
    for entry, argtypes in entries.items():
        fn = getattr(handle, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.lsv2_error_string.argtypes = [ctypes.c_int]
    handle.lsv2_error_string.restype = ctypes.c_char_p
    return handle


def parent_expand(root: Path):
    """The parent's ops/expand.py, imported from a copy of its package, on
    a library built from its own csrc/expand.cu."""
    pkg = OUT / "parent_pkg"
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(root / "langsplatv2_tpu_torch", pkg / "lsv2_parent")
    sys.path.insert(0, str(pkg.resolve()))
    mod = importlib.import_module("lsv2_parent.ops.expand")
    pk = mod.kernels
    pk._library = build_library(
        pk.CSRC, "parent", pk.SOURCES["expand.cu"],
        {"lsv2_expand_entries": pk.ENTRY_POINTS["lsv2_expand_entries"]})
    return mod


def bench_1080p(dev):
    """Phase 5's K1 inputs at 1920x1080 and its max_entries."""
    model = cs.from_numpy_params(cs.bench_scene(1_000_000), device=dev)
    h, w = 1080, 1920
    view, pm, tfx, tfy = cs.bench_camera(h, w)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    with torch.no_grad():
        op = model.get_opacity()[:, 0].contiguous()
        proj = projection.preprocess(
            model.xyz, model.get_scaling(), model.get_rotation(),
            model.get_features(), None, T(view), T(pm),
            torch.zeros(3, device=dev), tfx, tfy, w, h, 0, opacities=op)
    total = int(proj.tiles_touched.sum())
    budget = min(-(-int(total * 1.07) // 4096) * 4096, cs.LOADS[0][3])
    return projection.detach(proj), op, -(-w // 16), -(-h // 16), budget


def device_launches(fn) -> tuple[int, float]:
    """The kernels and memsets one call of fn puts on the device, and
    their device time in ms (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(on_device), sum(e.time_range.elapsed_us()
                               for e in on_device) / 1e3


def phase_line(lib, fn) -> str:
    """fn twice on the phase library (the first read drops the warm-up's
    counts); thread 0's phase shares."""
    buf = (ctypes.c_ulonglong * 16)()
    this = kernels._library
    kernels._library = lib
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        lib.lsv2_expand_phases(ctypes.cast(buf, ctypes.c_void_p))
    kernels._library = this
    total = buf[15]
    return ("  phases: " + ", ".join(
        f"{lab} {buf[k] / total:.3f}" for k, lab in enumerate(PHASE_LABELS))
        + f"; {total / max(buf[14], 1):.0f} cycles a staging pass "
        "(thread 0)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_expand: no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kernels.library()
    sides = {"this": expand}
    if args.parent:
        sides["parent"] = parent_expand(args.parent)
    marked = None
    if args.phases:
        marked = build_library(
            kernels.CSRC, "phases", kernels.SOURCES["expand.cu"],
            {"lsv2_expand_entries":
             kernels.ENTRY_POINTS["lsv2_expand_entries"]}, ["-DLSV2_PHASES"])
        marked.lsv2_expand_phases.argtypes = [ctypes.c_void_p]

    proj, op, gx, gy, budget = bench_1080p(dev)
    wide, wop, wgx, wgy, wcuts = cs.wide_expand_case(dev)
    inputs = {"1080p": (proj, op, gx, gy, budget),
              "whole grid": (wide, wop, wgx, wgy, wcuts[0])}
    for label, (p, o, x, y, e) in inputs.items():
        print(f"{label}: {p.xy.shape[0]} Gaussians, "
              f"{int(p.tiles_touched.sum())} slots of tiles, max_entries "
              f"{e}, grid {x} x {y}", flush=True)
        for s in (0, SUBDIV):
            name = f"K1 {label}" + (f" with_alpha={s}" if s else "")
            calls = {side: (lambda m=m: m.expand_entries(
                         p, o, x, y, e, with_alpha=s))
                     for side, m in sides.items()}
            outs = {side: fn() for side, fn in calls.items()}
            if "parent" in outs and not all(
                    torch.equal(a, b) for a, b in zip(outs["this"],
                                                       outs["parent"])):
                sys.exit(f"profile_expand: {name}: this commit and the "
                         "parent differ")
            del outs
            times = {}
            for side in ("parent", "this", "this", "parent"):
                if side in calls:
                    times.setdefault(side, []).append(
                        cs.cuda_ms(calls[side], 20)[0])
            launches = {side: device_launches(fn)
                        for side, fn in calls.items()}
            print(f"{name}: " + "; ".join(
                f"{k} {v} ms, {launches[k][0]} device launches a call "
                f"({launches[k][1]:.4f} ms of device time)"
                for k, v in times.items()), flush=True)
            if marked is not None:
                print(phase_line(marked, calls["this"]), flush=True)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
