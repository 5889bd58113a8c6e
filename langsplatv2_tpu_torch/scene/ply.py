"""Minimal PLY reader/writer, numpy only (a copy of
langsplatv2_tpu/scene/ply.py: the port may not import the JAX package).

Supports the two encodings 3DGS artifacts use: `binary_little_endian` (what
the reference writes, scene/gaussian_model.py:284-306) and `ascii` (seen in
some COLMAP exports). Reads/writes a single 'vertex' element of scalar
float/uchar/double properties, returned as a NumPy structured array.
"""
from __future__ import annotations

import io
import os

import numpy as np

_PLY_TO_NUMPY = {
    "float": "<f4", "float32": "<f4",
    "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1",
    "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2",
    "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}
_NUMPY_TO_PLY = {
    np.dtype("float32"): "float",
    np.dtype("float64"): "double",
    np.dtype("uint8"): "uchar",
    np.dtype("int32"): "int",
    np.dtype("uint32"): "uint",
}


def read_ply(path: str) -> dict[str, np.ndarray]:
    """Read a PLY file; returns {element_name: structured array}."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    if not header or header[0].strip() != "ply":
        raise ValueError(f"{path}: missing 'ply' magic")
    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    for line in header[1:]:
        parts = line.strip().split()
        if not parts or parts[0] == "comment":
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                raise ValueError(f"{path}: list properties not supported")
            elements[-1][2].append((parts[-1], _PLY_TO_NUMPY[parts[1]]))

    out = {}
    offset = 0
    if fmt == "binary_little_endian":
        for name, count, props in elements:
            dtype = np.dtype(props)
            nbytes = dtype.itemsize * count
            out[name] = np.frombuffer(body[offset:offset + nbytes], dtype=dtype).copy()
            offset += nbytes
    elif fmt == "ascii":
        text = body.decode("ascii")
        rows = np.loadtxt(io.StringIO(text), ndmin=2)
        r = 0
        for name, count, props in elements:
            dtype = np.dtype(props)
            arr = np.empty(count, dtype=dtype)
            block = rows[r:r + count]
            for i, (pname, _) in enumerate(props):
                arr[pname] = block[:, i]
            out[name] = arr
            r += count
    else:
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    return out


def write_ply(path: str, vertex: np.ndarray, element_name: str = "vertex") -> None:
    """Write a structured array as binary_little_endian PLY."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lines = ["ply", "format binary_little_endian 1.0",
             f"element {element_name} {len(vertex)}"]
    for name in vertex.dtype.names:
        base = vertex.dtype[name]
        lines.append(f"property {_NUMPY_TO_PLY[base.base if base.shape else base]} {name}")
    lines.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(lines) + "\n").encode("ascii"))
        # Ensure little-endian packed layout.
        le = vertex.astype(
            np.dtype([(n, vertex.dtype[n].str.replace(">", "<")) for n in vertex.dtype.names])
        )
        f.write(le.tobytes())
