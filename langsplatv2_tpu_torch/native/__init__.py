"""Native (C++) host data path, through ctypes
(port of langsplatv2_tpu/native/__init__.py, with its own copy of
feature_loader.cpp).

`load_language_feature` replaces the np.load + nearest resize + gather of
`Camera.get_language_feature` with a memory-mapped, multithreaded loader;
`read_points3d_bin` parses COLMAP's points3D.bin. The library is built
with the host's g++ at first use into
`build/langsplatv2_tpu_torch/native/` (never into the package tree) and
rebuilt when the source is newer. Without a compiler both functions return
None and the callers take their numpy paths.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "feature_loader.cpp"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "langsplatv2_tpu_torch" / "native")
LIB_PATH = BUILD_DIR / "libfeature_loader.so"
# A portable baseline ISA: a library built on one host must not fault on
# an older one.
CXXFLAGS = ["-O3", "-march=x86-64-v2", "-fPIC", "-shared", "-std=c++17",
            "-pthread"]
_lock = threading.Lock()
_lib = None
_tried = False


def build() -> Path:
    """Compile the library unless it is newer than its source. Several
    processes may build at once: each writes its own file and renames it
    into place."""
    if LIB_PATH.exists() and \
            LIB_PATH.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libfeature_loader.{os.getpid()}.so"
    cxx = os.environ.get("CXX", "g++")
    subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)], check=True,
                   capture_output=True, timeout=300)
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.SubprocessError):
            return None
        lib.lsv2_load_language_feature.restype = ctypes.c_int64
        lib.lsv2_load_language_feature.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8)]
        lib.lsv2_read_points3d_bin.restype = ctypes.c_int64
        lib.lsv2_read_points3d_bin.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_language_feature(seg_path: str, feat_path: str, level: int,
                          height: int, width: int, feat_dim: int = 512):
    """(features [D, H, W] f32, mask [1, H, W] bool) of SAM level `level`,
    the segment map resized to H x W by nearest neighbour, segment -1
    masked (its feature row wraps to the last, as numpy indexing does); None
    when the library is unavailable or the files are not what it reads."""
    lib = _load()
    if lib is None:
        return None
    feat = np.empty((feat_dim, height, width), np.float32)
    mask = np.empty((height, width), np.uint8)
    d = lib.lsv2_load_language_feature(
        seg_path.encode(), feat_path.encode(), level, height, width,
        _ptr(feat, ctypes.c_float), _ptr(mask, ctypes.c_uint8))
    if d != feat_dim:
        return None
    return feat, mask.astype(bool)[None]


def read_points3d_bin(path: str):
    """COLMAP points3D.bin -> (xyz [n, 3] f64, rgb [n, 3] u8, error [n]
    f64), or None when the library is unavailable or the file unreadable."""
    lib = _load()
    if lib is None:
        return None
    null_d = ctypes.POINTER(ctypes.c_double)()
    null_u = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.lsv2_read_points3d_bin(path.encode(), 0, null_d, null_u, null_d)
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float64)
    got = lib.lsv2_read_points3d_bin(
        path.encode(), n, _ptr(xyz, ctypes.c_double),
        _ptr(rgb, ctypes.c_uint8), _ptr(err, ctypes.c_double))
    if got != n:
        return None
    return xyz, rgb, err
