"""Build and load the port's hand-written CUDA kernels.

No JAX counterpart: Pallas kernels compile inside `pl.pallas_call`. Here
each `csrc/*.cu` source has a plain C interface; all sources are compiled
by nvcc for sm_90a at first use, each by its own nvcc process (started
together), linked into `build/langsplatv2_tpu_torch/libkernels.so` and
loaded with ctypes. The library is rebuilt when the hash of the sources or
flags changes. Nothing here runs at import time: the CPU tests import
every module on a host without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "langsplatv2_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
# expand.cu, cascade.cu, blend.cu, feature_bwd.cu, feature_bwd_topk.cu,
# rgb_bwd.cu, probe.cu, preprocess.cu and preprocess_bwd.cu round every f32
# op on its own (no fused multiply-add), as their plain PyTorch versions
# do: the entry sets of K1 and K8, the alpha / termination tests of K2 and
# K9's compares then agree bit for bit, K4, K5 and K7 replay K2's blend
# weights exactly, the preprocess's fields are the plain path's, and its
# adjoint's masks the plain path's autograd's. topk_codes.cu keeps nvcc's
# contraction, as PyTorch's softmax kernels are built, whose rounding it
# replays.
# Every source but errors.cu is built with ptxas's report
# (registers, shared memory, spills of each instantiation), kept in
# BUILD_DIR/<source stem>.log: `ptxas_report`.
# Headers (csrc/*.cuh) enter the build hash.
SOURCES = {
    "expand.cu": ["-fmad=false", "-Xptxas=-v"],
    "cascade.cu": ["-fmad=false", "-Xptxas=-v"],
    "blend.cu": ["-fmad=false", "-Xptxas=-v"],
    "query.cu": ["-Xptxas=-v"],
    "feature_bwd.cu": ["-fmad=false", "-Xptxas=-v"],
    "feature_bwd_topk.cu": ["-fmad=false", "-Xptxas=-v"],
    "gram.cu": ["-Xptxas=-v"],
    "rgb_bwd.cu": ["-fmad=false", "-Xptxas=-v"],
    "probe.cu": ["-fmad=false", "-Xptxas=-v"],
    "preprocess.cu": ["-fmad=false", "-Xptxas=-v"],
    "preprocess_bwd.cu": ["-fmad=false", "-Xptxas=-v"],
    "topk_codes.cu": ["-Xptxas=-v"],
    "errors.cu": [],
}

# (name, argument types) of every C entry point; all return a cudaError_t.
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
ENTRY_POINTS = {
    # xy depth conic opacity rect_min rect_max tiles ends n grid_x
    # max_entries sentinel exact_cull inv_cull_alpha tile depth gauss subdiv
    # lm total stream
    "lsv2_expand_entries": [_P] * 8 + [_I] * 5 + [_F] + [_P] * 3 + [_I]
    + [_P] * 3,
    # subdiv out[5]
    "lsv2_expand_occupancy": [_I, _P],
    # g_sorted tile_start tile_count geom qw qi bg num_tiles grid_x topk
    # channels tile_base grid_tiles rgb feat final_t stats stream
    "lsv2_blend_tiles": [_P] * 7 + [_I] * 6 + [_P] * 5,
    # g_sorted tile_start tile_count rows bg num_tiles grid_x topk channels
    # out_bf16 per_level cells_bf16 rgb feat final_t stats stream
    "lsv2_blend_tiles_fast16": [_P] * 5 + [_I] * 7 + [_P] * 5,
    # g_sorted tile_start tile_count rows bg phi gram num_tiles grid_x topk
    # levels pq per_level cells_bf16 rgb raw nrm2 final_t stats stream
    "lsv2_blend_tiles_query": [_P] * 7 + [_I] * 7 + [_P] * 6,
    # the same with K after levels, then frag frag_words before the stream
    "lsv2_blend_tiles_query_any": [_P] * 7 + [_I] * 8 + [_P] * 6 + [_L, _P],
    # g_sorted tile_start tile_count geom feats bg num_tiles grid_x stride
    # c0 channels rgb feat final_t stats stream
    "lsv2_blend_tiles_dense": [_P] * 6 + [_I] * 5 + [_P] * 5,
    # stage n grid_x grid_y budget chunks1 depth rect_min rect_max
    # tiles_touched xy conic opacity inv_cull_alpha order gauss zbuf meta
    # keys status0 counts1 rows mask1 out start count total overflow stream
    "lsv2_cascade": [_I] * 6 + [_P] * 7 + [_F] + [_P] * 15,
    # wm phi gram n_tiles levels pq raw nrm2 stream
    "lsv2_query_map_tiles": [_P] * 3 + [_I] * 3 + [_P] * 3,
    "lsv2_query_map_tiles_bf16": [_P] * 3 + [_I] * 3 + [_P] * 3,
    # bf16 levels pq out[5]
    "lsv2_query_occupancy": [_I] * 3 + [_P],
    # bf16 wm phi gram n_tiles levels K pq raw nrm2 frag frag_words stream
    "lsv2_query_map_tiles_any": [_I] + [_P] * 3 + [_I] * 4 + [_P] * 3
    + [_L, _P],
    # bf16 out[5]
    "lsv2_query_any_occupancy": [_I, _P],
    # g_sorted tile_start tile_count geom cot num_tiles grid_x tile_base
    # grid_tiles channels num_entries dfeat stream
    "lsv2_feature_bwd": [_P] * 5 + [_I] * 5 + [_L] + [_P] * 2,
    # out[5]
    "lsv2_feature_bwd_occupancy": [_P],
    # g_win kept geom qi cot num_tiles grid_x cap channels topk dproj stream
    "lsv2_feature_bwd_topk": [_P] * 5 + [_I] * 5 + [_P] * 2,
    # channels topk out[5]
    "lsv2_feature_bwd_topk_occupancy": [_I, _I, _P],
    # bwd kpk any seg w rhs gfull num_tiles C pass[12] eps inv_hw upstream
    # out dphi dg gsplit stream
    "lsv2_gram": [_I] * 3 + [_P] * 4 + [_I] * 2 + [_P] + [_F] * 2
    + [_P] * 6,
    # bwd kpk any out[5]
    "lsv2_gram_occupancy": [_I] * 3 + [_P],
    # g_sorted tile_start tile_count geom pack num_tiles grid_x dgrad stream
    "lsv2_rgb_bwd": [_P] * 5 + [_I] * 2 + [_P] * 2,
    # out[5]
    "lsv2_rgb_bwd_occupancy": [_P],
    # in out n mode stats stream
    "lsv2_cell_chain": [_P] * 2 + [_L, _I, _P, _P],
    # mode cells channels topk out[5]
    "lsv2_blend_occupancy": [_I] * 4 + [_P],
    # host_params view proj campos means scales rotations cov3d opacity
    # sh_dc sh_rest dc_stride rest_stride sh_degree n xy depth conic radius
    # rgb rect_min rect_max tiles stream
    "lsv2_preprocess": [_P] * 11 + [_L] * 2 + [_I] * 2 + [_P] * 9,
    # sh_degree out[5]
    "lsv2_preprocess_occupancy": [_I, _P],
    # host_params view proj campos means scales rotations cov3d sh_dc
    # sh_rest dc_stride rest_stride sh_degree n g_xy g_conic g_rgb
    # xy_stride conic_stride rgb_stride d_means d_scales d_rotations d_dc
    # d_rest d_dc_stride d_rest_stride stream
    "lsv2_preprocess_bwd": [_P] * 10 + [_L] * 2 + [_I] * 2 + [_P] * 3
    + [_L] * 3 + [_P] * 5 + [_L] * 2 + [_P],
    # sh_degree out[5]
    "lsv2_preprocess_bwd_occupancy": [_I, _P],
    # logits segs K levels k weights indices stream
    "lsv2_topk_codes": [_P, _L] + [_I] * 3 + [_P] * 3,
    # d_weights weights indices segs K levels k d_logits stream
    "lsv2_topk_codes_bwd": [_P] * 3 + [_L] + [_I] * 3 + [_P] * 2,
    # k backward out[5]
    "lsv2_topk_codes_occupancy": [_I, _I, _P],
}

NULL = ctypes.c_void_p(None)   # an absent optional pointer argument
_library = None


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _digest(nvcc: str) -> str:
    h = hashlib.sha256(" ".join([nvcc, *ARCH, *COMMON]).encode())
    for name, flags in sorted(SOURCES.items()):
        h.update(name.encode() + " ".join(flags).encode())
        h.update((CSRC / name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    return h.hexdigest()


def build() -> tuple[Path, float]:
    """Compile (if stale) and return (library path, seconds spent building)."""
    nvcc = _nvcc()
    digest = _digest(nvcc)
    lib = BUILD_DIR / "libkernels.so"
    stamp = BUILD_DIR / "libkernels.sha256"
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib, 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    jobs = []
    for name, flags in SOURCES.items():
        obj = BUILD_DIR / f"{Path(name).stem}.{tag}.o"
        cmd = [nvcc, *ARCH, *COMMON, *flags, "-c", str(CSRC / name),
               "-o", str(obj)]
        jobs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for name, _obj, proc in jobs:
        out, _ = proc.communicate()
        (BUILD_DIR / f"{Path(name).stem}.log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name} (exit {proc.returncode})\n{out}")
    if failures:
        raise RuntimeError("kernel build failed\n" + "\n".join(failures))
    tmp = BUILD_DIR / f"libkernels.{tag}.so"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp),
         *[str(obj) for _n, obj, _p in jobs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _n, obj, _p in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"kernel link failed\n{link.stdout}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib, time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()[0]))
        for name, argtypes in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.lsv2_error_string.argtypes = [ctypes.c_int]
        lib.lsv2_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library


def ptxas_report(source: str = "blend.cu") -> list[dict]:
    """ptxas's report of each kernel of `source` from its build log:
    (mangled name, registers, stack frame, spill store and load bytes)."""
    log = BUILD_DIR / f"{Path(source).stem}.log"
    rows, cur = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(name=m.group(1))
            rows.append(cur)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            cur["line"] = line.strip()
    return rows


def occupancy(entry: str, *args) -> dict:
    """A kernel's occupancy from its C entry point `entry`, called with
    `args` and an int[5] it fills (CUDA only): resident blocks and warps an
    SM, shared bytes, registers and local (spill, stack) bytes a thread,
    threads a block."""
    out = (ctypes.c_int * 5)()
    launch(entry, *args, ctypes.cast(out, ctypes.c_void_p))
    return dict(blocks_per_sm=out[0], warps_per_sm=out[0] * out[4] // 32,
                smem_bytes=out[1], registers=out[2], local_bytes=out[3],
                threads=out[4])


def launch(name: str, *args) -> None:
    """Call C entry point `name`; raise if it reports a CUDA error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.lsv2_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_tensor(t, name: str, dtype, shape: tuple, device) -> None:
    """Raise unless `t` has this dtype, shape (None = any extent), device
    and a contiguous layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
