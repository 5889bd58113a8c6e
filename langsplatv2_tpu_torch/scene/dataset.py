"""Scene-info readers: COLMAP and Blender (NeRF-synthetic) datasets
(port of langsplatv2_tpu/scene/dataset.py; reference
scene/dataset_readers.py and utils/camera_utils.py).

The same directory conventions (`sparse/0` + `images/`, or
`transforms_train.json`), eval split (every `llffhold`-th camera),
nerf++ camera-extent normalization, point-cloud PLY, and resolution policy
(divide by 1, 2, 4 or 8, or cap the width at 1600 when -1); images are
read with PIL, as in the JAX package.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np
from PIL import Image

from . import colmap, ply
from .cameras import Camera
from ..utils.camera_math import focal_to_fov, fov_to_focal, get_world_to_view

WARNED_RESOLUTION = [False]


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovY: float
    FovX: float
    image_path: str
    image_name: str
    width: int
    height: int


@dataclass
class SceneInfo:
    point_cloud_path: str | None
    points: np.ndarray | None
    colors: np.ndarray | None
    train_cameras: list[CameraInfo]
    test_cameras: list[CameraInfo]
    nerf_normalization: dict
    is_blender: bool = False


def get_nerfpp_norm(cam_infos: list[CameraInfo]) -> dict:
    """Camera extent: diagonal radius of camera centers * 1.1
    (reference dataset_readers.py:45-66)."""
    centers = []
    for cam in cam_infos:
        w2c = get_world_to_view(cam.R, cam.T)
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    centers = np.stack(centers)
    avg = centers.mean(axis=0)
    dist = np.linalg.norm(centers - avg, axis=1)
    diagonal = dist.max()
    radius = diagonal * 1.1
    return {"translate": -avg, "radius": float(radius)}


def read_colmap_scene_info(path: str, images_dir: str | None = None,
                           eval_split: bool = False, llffhold: int = 8) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    try:
        cams_intr = colmap.read_intrinsics_binary(os.path.join(sparse, "cameras.bin"))
        cams_extr = colmap.read_extrinsics_binary(os.path.join(sparse, "images.bin"))
    except FileNotFoundError:
        cams_intr = colmap.read_intrinsics_text(os.path.join(sparse, "cameras.txt"))
        cams_extr = colmap.read_extrinsics_text(os.path.join(sparse, "images.txt"))

    images_folder = os.path.join(path, images_dir or "images")
    cam_infos = []
    for idx, key in enumerate(sorted(cams_extr.keys(), key=lambda k: cams_extr[k].name)):
        extr = cams_extr[key]
        intr = cams_intr[extr.camera_id]
        R = np.transpose(colmap.qvec_to_rotmat(extr.qvec))
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            focal_x = focal_y = intr.params[0]
        elif intr.model == "PINHOLE":
            focal_x, focal_y = intr.params[0], intr.params[1]
        else:
            raise ValueError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE) are supported"
            )
        FovY = focal_to_fov(focal_y, intr.height)
        FovX = focal_to_fov(focal_x, intr.width)
        image_name = os.path.splitext(os.path.basename(extr.name))[0]
        cam_infos.append(CameraInfo(
            uid=idx, R=R, T=T, FovY=FovY, FovX=FovX,
            image_path=os.path.join(images_folder, os.path.basename(extr.name)),
            image_name=image_name, width=intr.width, height=intr.height,
        ))

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    points = colors = None
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3d_text(os.path.join(sparse, "points3D.txt"))
        store_point_cloud_ply(ply_path, xyz, rgb)
        points, colors = xyz, rgb
    else:
        points, colors = fetch_point_cloud_ply(ply_path)

    return SceneInfo(ply_path, points, colors, train, test, norm)


def read_blender_scene_info(path: str, white_background: bool = False,
                            eval_split: bool = True, extension: str = ".png") -> SceneInfo:
    """NeRF-synthetic transforms_{train,test}.json reader
    (reference dataset_readers.py:195-275)."""

    def read_split(transforms_file):
        with open(os.path.join(path, transforms_file)) as f:
            contents = json.load(f)
        fovx = contents["camera_angle_x"]
        infos = []
        for idx, frame in enumerate(contents["frames"]):
            image_path = os.path.join(path, frame["file_path"] + extension)
            c2w = np.array(frame["transform_matrix"])
            c2w[:3, 1:3] *= -1  # Blender -> COLMAP camera axes
            w2c = np.linalg.inv(c2w)
            R = np.transpose(w2c[:3, :3])
            T = w2c[:3, 3]
            with Image.open(image_path) as im:
                width, height = im.size
            fovy = focal_to_fov(fov_to_focal(fovx, width), height)
            infos.append(CameraInfo(
                uid=idx, R=R, T=T, FovY=fovy, FovX=fovx,
                image_path=image_path,
                image_name=os.path.splitext(os.path.basename(image_path))[0],
                width=width, height=height,
            ))
        return infos

    train = read_split("transforms_train.json")
    test = read_split("transforms_test.json") if (
        eval_split and os.path.exists(os.path.join(path, "transforms_test.json"))
    ) else []
    if not eval_split:
        train = train + test
        test = []
    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        # Random init inside [-1.3, 1.3]^3 like the reference (100k points).
        num_pts = 100_000
        rng = np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        colors = rng.random((num_pts, 3))
        store_point_cloud_ply(ply_path, xyz, colors)
    else:
        xyz, colors = fetch_point_cloud_ply(ply_path)
    return SceneInfo(ply_path, xyz, colors, train, test, norm, is_blender=True)


def store_point_cloud_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Write xyz + normals(0) + uchar rgb (reference fetchPly/storePly schema)."""
    dtype = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
             ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
             ("red", "u1"), ("green", "u1"), ("blue", "u1")]
    arr = np.empty(len(xyz), dtype=dtype)
    arr["x"], arr["y"], arr["z"] = xyz.T.astype(np.float32)
    arr["nx"] = arr["ny"] = arr["nz"] = 0.0
    rgb255 = np.clip(rgb * 255, 0, 255).astype(np.uint8)
    arr["red"], arr["green"], arr["blue"] = rgb255.T
    ply.write_ply(path, arr)


def fetch_point_cloud_ply(path: str):
    data = ply.read_ply(path)["vertex"]
    xyz = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float64)
    rgb = np.stack([data["red"], data["green"], data["blue"]], axis=1) / 255.0
    return xyz, rgb


def load_camera(info: CameraInfo, resolution_scale: float, resolution: int,
                uid: int) -> Camera:
    """Resolution policy from reference utils/camera_utils.py:19-53."""
    with Image.open(info.image_path) as img:
        orig_w, orig_h = img.size
        if resolution in (1, 2, 4, 8):
            scale = resolution_scale * resolution
            target = (round(orig_w / scale), round(orig_h / scale))
        else:
            if resolution == -1:
                if orig_w > 1600:
                    if not WARNED_RESOLUTION[0]:
                        print("[ INFO ] Encountered quite large input images "
                              "(>1.6K pixels width), rescaling to 1.6K.")
                        WARNED_RESOLUTION[0] = True
                    global_down = orig_w / 1600
                else:
                    global_down = 1
            else:
                global_down = orig_w / resolution
            scale = global_down * resolution_scale
            target = (int(orig_w / scale), int(orig_h / scale))
        resized = img.resize(target)
        arr = np.asarray(resized, dtype=np.float32) / 255.0

    if arr.ndim == 2:
        arr = arr[..., None]
    arr = np.transpose(arr, (2, 0, 1))  # [C, H, W]
    if arr.shape[0] == 4:
        alpha = arr[3:4]
        image = arr[:3] * alpha
    else:
        image = arr[:3]
    return Camera(
        colmap_id=info.uid, R=info.R, T=info.T, FoVx=info.FovX, FoVy=info.FovY,
        image=image, image_name=info.image_name, uid=uid,
    )


def camera_to_json(idx: int, camera: CameraInfo) -> dict:
    """cameras.json entry (reference utils/camera_utils.py:63-82)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = camera.R.transpose()
    Rt[:3, 3] = camera.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    pos = W2C[:3, 3]
    rot = W2C[:3, :3]
    return {
        "id": idx,
        "img_name": camera.image_name,
        "width": camera.width,
        "height": camera.height,
        "position": pos.tolist(),
        "rotation": [r.tolist() for r in rot],
        "fy": fov_to_focal(camera.FovY, camera.height),
        "fx": fov_to_focal(camera.FovX, camera.width),
    }
