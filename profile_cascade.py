#!/usr/bin/env python3
"""K8 (langsplatv2_tpu_torch/csrc/cascade.cu) and K9 (csrc/probe.cu) on the
card, through their wrappers `ops/cascade.py::cascade_binning` and
`ops/probe.py::cell_chain`.

    python3 profile_cascade.py [--parent DIR] [--phases]

Cases, each timed through the wrapper (CUDA events, 20 calls after a
warm-up):
- "K8 1080p" and "K8 986x728": chip_smoke.py phase 16's inputs, the bench
  scene (1,000,000 Gaussians) preprocessed at the load, the budget the
  probed total plus 7% rounded up to 4096, as phase 4 sets max_entries;
- "K9 f32" and "K9 bf16": phase 18's [512, 256, 256] batch.
--parent DIR  a checkout of another commit (`git archive REV | tar -x -C
              DIR`): its package is copied under build/profile_cascade as
              `lsv2_parent`, its csrc/cascade.cu and csrc/probe.cu are built
              into a second library, and each case runs the parent's
              wrapper and this one in turns (parent, this, this, parent).
              Both must give the same outputs (checked once a case).
--phases      K8: this commit's cascade.cu rebuilt with -DLSV2_PHASES
              (csrc/phase_marks.cuh), thread 0 of each block of the level-1
              passes, each phase's share of its pass's cycles and the
              cycles a chunk; K9: each side's SASS instructions a chain by
              unit (cuobjdump), this commit's bf16 form also on its common
              path alone (probe.cu built with -DLSV2_PROBE_HOT_PATH).
For each case and side: the device operations one wrapper call makes (K8's
besides torch.sort's are cascade.LAUNCHES), their device time and the
largest kernels' share (torch.profiler). Prints the card's name and power
limit first. Needs a CUDA device.
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
from langsplatv2_tpu_torch.ops import cascade, kernels, probe, projection

OUT = Path("build") / "profile_cascade"
SOURCES = ("cascade.cu", "probe.cu")
ENTRIES = ("lsv2_cascade", "lsv2_cascade_level", "lsv2_cell_chain")
COUNT_PHASES = ["staging", "culled pairs", "totals and ticket", "last scan"]
WRITE_PHASES = ["staging and bits", "the chunk's offsets", "writes"]


def build_library(csrc: Path, name: str, sources: dict, entry_points: dict,
                  extra=()):
    """nvcc each of `sources` (file: flags) from csrc, and this commit's
    errors.cu, into OUT/lib<name>.so; the entry points that the library
    has get their argument types from `entry_points`."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    objs, procs = [], []
    for src, fl in [(csrc / s, f) for s, f in sources.items()] + [
            (kernels.CSRC / "errors.cu", [])]:
        obj = OUT / f"{name}.{src.stem}.o"
        cmd = [kernels._nvcc(), *kernels.ARCH, *kernels.COMMON, *fl, *extra,
               "-I", str(csrc), "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
        objs.append(str(obj))
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"profile_cascade: nvcc {src} failed\n{out}")
    done = subprocess.run([kernels._nvcc(), *kernels.ARCH, "-shared", "-o",
                           str(lib), *objs], capture_output=True, text=True)
    if done.returncode:
        sys.exit(f"profile_cascade: link failed\n{done.stdout}")
    handle = ctypes.CDLL(str(lib.resolve()))
    for entry in ENTRIES:
        if entry in entry_points and hasattr(handle, entry):
            fn = getattr(handle, entry)
            fn.argtypes = entry_points[entry]
            fn.restype = ctypes.c_int
    handle.lsv2_error_string.argtypes = [ctypes.c_int]
    handle.lsv2_error_string.restype = ctypes.c_char_p
    return handle, lib


def parent_modules(root: Path):
    """The parent's ops/cascade.py and ops/probe.py, imported from a copy
    of its package, on a library built from its own sources."""
    pkg = OUT / "parent_pkg"
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(root / "langsplatv2_tpu_torch", pkg / "lsv2_parent")
    sys.path.insert(0, str(pkg.resolve()))
    casc = importlib.import_module("lsv2_parent.ops.cascade")
    prob = importlib.import_module("lsv2_parent.ops.probe")
    pk = casc.kernels
    pk._library, lib = build_library(
        pk.CSRC, "parent", {s: pk.SOURCES[s] for s in SOURCES},
        pk.ENTRY_POINTS)
    return casc, prob, lib


def load_inputs(dev, h: int, w: int, probe_budget: int):
    """Phase 16's K8 inputs at h x w and phase 4's max_entries."""
    model = cs.from_numpy_params(cs.bench_scene(1_000_000), device=dev)
    view, pm, tfx, tfy = cs.bench_camera(h, w)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    with torch.no_grad():
        op = model.get_opacity()[:, 0].contiguous()
        proj = projection.preprocess(
            model.xyz, model.get_scaling(), model.get_rotation(),
            model.get_features(), None, T(view), T(pm),
            torch.zeros(3, device=dev), tfx, tfy, w, h, 0, opacities=op)
    total = int(proj.tiles_touched.sum())
    budget = min(-(-int(total * 1.07) // 4096) * 4096, probe_budget)
    return projection.detach(proj), op, -(-w // 16), -(-h // 16), budget


def device_split(fn, top: int = 6) -> tuple[int, float, str]:
    """(device operations of one call of fn, their device time in ms, the
    `top` largest by name with their us)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in on_device:
        key = e.name.replace("(anonymous namespace)::", "")[:48]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return (len(on_device), sum(by_name.values()) / 1e3,
            ", ".join(f"{k} {v:.1f}" for k, v in ranked))


def run_case(name: str, calls: dict, same) -> None:
    """Check the sides agree, time them in turns, print each's line."""
    outs = {side: fn() for side, fn in calls.items()}
    if "parent" in outs and not same(outs["this"], outs["parent"]):
        sys.exit(f"profile_cascade: {name}: this commit and the parent "
                 "differ")
    del outs
    times = {}
    for side in ("parent", "this", "this", "parent"):
        if side in calls:
            times.setdefault(side, []).append(cs.cuda_ms(calls[side], 20)[0])
    for side, fn in calls.items():
        ops, dev_ms, split = device_split(fn)
        ms = ", ".join(f"{t:.4f}" for t in times[side])
        print(f"{name} {side}: {ms} ms; {ops} device operations a call, "
              f"{dev_ms:.4f} ms of device time ({split} us)", flush=True)
    torch.cuda.empty_cache()


def phase_line(lib, fn) -> str:
    """fn twice on the phase library (the first read drops the warm-up's
    counts); thread 0's phase shares in each level-1 pass."""
    buf = (ctypes.c_ulonglong * 16)()
    this = kernels._library
    kernels._library = lib
    for _ in range(2):
        fn()
        torch.cuda.synchronize()
        lib.lsv2_cascade_phases(ctypes.cast(buf, ctypes.c_void_p))
    kernels._library = this
    parts = []
    for label, slots, labels in (("count", range(0, 4), COUNT_PHASES),
                                 ("write", range(4, 7), WRITE_PHASES)):
        total = sum(buf[k] for k in slots) or 1
        parts.append(f"{label} pass " + ", ".join(
            f"{lab} {buf[k] / total:.3f}" for k, lab in zip(slots, labels))
            + f" ({total / max(buf[14] / 2, 1):.0f} cycles a chunk)")
    return "  phases (thread 0): " + "; ".join(parts)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_cascade: no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    kernels.library()
    for source in SOURCES:
        for row in kernels.ptxas_report(source):
            print(f"ptxas {source}: {row['name']}: {row.get('line', '')}, "
                  f"spills {row.get('spill_stores')}/{row.get('spill_loads')}",
                  flush=True)
    sides = {"this": (cascade, probe)}
    libs = {"this": kernels.build()[0]}
    if args.parent:
        casc, prob, libs["parent"] = parent_modules(args.parent)
        sides["parent"] = (casc, prob)
    marked = None
    if args.phases:
        marked, _ = build_library(
            kernels.CSRC, "phases", {"cascade.cu":
                                     kernels.SOURCES["cascade.cu"]},
            kernels.ENTRY_POINTS, ["-DLSV2_PHASES"])
        marked.lsv2_cascade_phases.argtypes = [ctypes.c_void_p]

    for label, h, w, probe_budget in cs.LOADS:
        p, o, gx, gy, budget = load_inputs(dev, h, w, probe_budget)
        print(f"K8 {label}: {p.xy.shape[0]} Gaussians, "
              f"{int(p.tiles_touched.sum())} rect tiles, budget {budget}, "
              f"grid {gx} x {gy}", flush=True)
        calls = {side: (lambda m=m[0]: m.cascade_binning(p, o, gx, gy,
                                                          budget))
                 for side, m in sides.items()}
        run_case(f"K8 {label}", calls, lambda a, b: all(
            torch.equal(x, y) for x, y in zip(a, b)))
        if marked is not None:
            print(phase_line(marked, calls["this"]), flush=True)
        del p, o, calls

    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((cs.PROBE_BLOCKS, 256, 256), generator=gen,
                   device=dev) * 2 - 1
    for form, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        calls = {side: (lambda m=m[1]: m.cell_chain(x, dtype))
                 for side, m in sides.items()}
        run_case(f"K9 {form}", calls, torch.equal)
    _, fell_back = probe.kernel_mode(x, 1)
    print(f"K9 bf16: {fell_back} of {x.numel() // 2} pairs ran the chain "
          "again with expf", flush=True)
    if args.phases:
        for side, lib in libs.items():
            print(f"K9 SASS a chain, {side}: {cs.sass_per_chain(lib)}",
                  flush=True)
        print("K9 SASS a chain, this, common path only: "
              f"{cs.sass_per_chain(cs.probe_common_path_library())}",
              flush=True)


if __name__ == "__main__":
    main()
