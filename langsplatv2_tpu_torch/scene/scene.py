"""Scene assembly (port of langsplatv2_tpu/scene/scene.py; reference
scene/__init__.py): COLMAP or Blender detection, the first run's copies
into the model directory (input.ply, cameras.json), the camera lists per
resolution scale shuffled with Python's global `random` (so that one seed
gives the JAX package's order), and `cameras_extent` from the nerf++
normalization. The model itself is made by the caller.
"""
from __future__ import annotations

import json
import os
import random
import shutil

from . import dataset
from .cameras import Camera


class Scene:
    def __init__(
        self,
        source_path: str,
        model_path: str,
        images: str | None = None,
        resolution: int = -1,
        white_background: bool = False,
        eval_split: bool = False,
        shuffle: bool = True,
        resolution_scales=(1.0,),
        load_images: bool = True,
    ):
        self.model_path = model_path
        self.source_path = source_path

        if os.path.exists(os.path.join(source_path, "sparse")):
            scene_info = dataset.read_colmap_scene_info(source_path, images, eval_split)
        elif os.path.exists(os.path.join(source_path, "transforms_train.json")):
            print("Found transforms_train.json file, assuming Blender data set!")
            scene_info = dataset.read_blender_scene_info(
                source_path, white_background, eval_split
            )
        else:
            raise ValueError(f"Could not recognize scene type for {source_path}")
        self.scene_info = scene_info

        if model_path:
            os.makedirs(model_path, exist_ok=True)
            input_ply = os.path.join(model_path, "input.ply")
            if scene_info.point_cloud_path and not os.path.exists(input_ply):
                shutil.copyfile(scene_info.point_cloud_path, input_ply)
            cam_json = os.path.join(model_path, "cameras.json")
            if not os.path.exists(cam_json):
                entries = [
                    dataset.camera_to_json(i, c)
                    for i, c in enumerate(scene_info.train_cameras + scene_info.test_cameras)
                ]
                with open(cam_json, "w") as f:
                    json.dump(entries, f)

        if shuffle:
            random.shuffle(scene_info.train_cameras)
            random.shuffle(scene_info.test_cameras)

        self.cameras_extent = scene_info.nerf_normalization["radius"]

        self.train_cameras: dict[float, list[Camera]] = {}
        self.test_cameras: dict[float, list[Camera]] = {}
        if load_images:
            for scale in resolution_scales:
                self.train_cameras[scale] = [
                    dataset.load_camera(info, scale, resolution, uid)
                    for uid, info in enumerate(scene_info.train_cameras)
                ]
                self.test_cameras[scale] = [
                    dataset.load_camera(info, scale, resolution, uid)
                    for uid, info in enumerate(scene_info.test_cameras)
                ]

    def get_train_cameras(self, scale: float = 1.0) -> list[Camera]:
        return self.train_cameras.get(scale, [])

    def get_test_cameras(self, scale: float = 1.0) -> list[Camera]:
        return self.test_cameras.get(scale, [])

    @property
    def points(self):
        return self.scene_info.points

    @property
    def colors(self):
        return self.scene_info.colors
