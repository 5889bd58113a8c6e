"""COLMAP sparse-reconstruction readers and writers, binary and text
(port of langsplatv2_tpu/scene/colmap.py; reference
scene/colmap_loader.py): cameras, images and points3D, and
`qvec_to_rotmat`. points3D.bin goes through the port's native reader
when it is built, else through struct.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # [4] (w, x, y, z)
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP world-to-cam quaternion -> rotation matrix
    (reference colmap_loader.py:43)."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_intrinsics_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cams[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return cams


def read_extrinsics_binary(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            vals = _read(f, "<idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(f, "<Q")
            f.seek(24 * num_pts, os.SEEK_CUR)  # skip (x, y, point3D_id) tracks
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8")
            )
    return images


def read_points3d_binary(path: str):
    """Returns (xyz [N,3], rgb [N,3] float in [0,1], error [N])."""
    from .. import native

    out = native.read_points3d_bin(path)
    if out is not None:
        xyz, rgb, err = out
        return xyz, rgb.astype(np.float64) / 255.0, err

    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3))
        rgb = np.empty((n, 3))
        err = np.empty(n)
        for i in range(n):
            vals = _read(f, "<QdddBBBd")
            xyz[i] = vals[1:4]
            rgb[i] = vals[4:7]
            err[i] = vals[7]
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyz, rgb / 255.0, err


def read_intrinsics_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            model = parts[1]
            cams[cam_id] = ColmapCamera(
                cam_id, model, int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]),
            )
    return cams


def read_extrinsics_text(path: str) -> dict[int, ColmapImage]:
    """Two lines an image: the header and its 2-D points, which may be an
    empty line (the reference reads the line after a header as its points
    whatever it holds; the JAX package drops empty lines first, which
    pairs the lines wrongly when an image has no points)."""
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f]
    headers = []
    i = 0
    while i < len(lines):
        if lines[i] and not lines[i].startswith("#"):
            headers.append(lines[i])
            i += 1              # the points line
        i += 1
    for header in headers:
        parts = header.split()
        image_id = int(parts[0])
        qvec = np.array([float(p) for p in parts[1:5]])
        tvec = np.array([float(p) for p in parts[5:8]])
        camera_id = int(parts[8])
        name = parts[9]
        images[image_id] = ColmapImage(image_id, qvec, tvec, camera_id, name)
    return images


def read_points3d_text(path: str):
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append([float(p) for p in parts[1:4]])
            rgbs.append([float(p) for p in parts[4:7]])
            errs.append(float(parts[7]))
    return np.array(xyzs), np.array(rgbs) / 255.0, np.array(errs)


# Writers (used by tests and the convert pipeline).

def write_intrinsics_binary(path: str, cams: dict[int, ColmapCamera]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            model_id = _MODEL_NAME_TO_ID[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model_id, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_extrinsics_binary(path: str, images: dict[int, ColmapImage]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(path: str, xyz: np.ndarray, rgb: np.ndarray, err: np.ndarray | None = None):
    """Points with empty tracks, the records packed at once (the JAX
    package's writer, a struct.pack a point, writes the same bytes)."""
    n = len(xyz)
    rec = np.zeros(n, dtype=[("id", "<u8"), ("xyz", "<f8", (3,)),
                             ("rgb", "u1", (3,)), ("err", "<f8"),
                             ("track", "<u8")])
    rec["id"] = np.arange(n)
    rec["xyz"] = xyz
    rec["rgb"] = np.clip(np.asarray(rgb) * 255, 0, 255).astype(np.uint8)
    rec["err"] = 0.0 if err is None else err
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        f.write(rec.tobytes())
