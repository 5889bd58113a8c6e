"""Camera objects and the language-feature ground truth
(port of langsplatv2_tpu/scene/cameras.py:24-138).

Host-side numpy, as in the JAX package: the transposed world-view and
full-projection matrices (the row-vector convention the rasterizer reads),
the camera centre, and the ground truth of SAM level `feature_level` from
`<name>_s.npy` [4, h, w] and `<name>_f.npy` [S, 512]: compact (the
segment table and map, `get_language_feature_compact`) or per pixel
([512, H, W] and its mask, `get_language_feature`, through the port's
native loader when it is built). Segment maps of another size are resized
with `resize_nearest`, numpy written to OpenCV's INTER_NEAREST index rule,
so that no path needs OpenCV. `MiniCam` is the viewer's camera, its
matrices given directly.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

import numpy as np

from ..utils import camera_math as cm

ZNEAR = 0.01
ZFAR = 100.0


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=INTER_NEAREST) for a
    2-D array: source index floor(x * (1 / (width / w))) in double
    precision, clamped to the last row or column."""
    h, w = img.shape

    def index(dst: int, src: int) -> np.ndarray:
        scale = 1.0 / (dst / src)
        return np.minimum(np.floor(np.arange(dst) * scale).astype(np.int64),
                          src - 1)

    return img[index(height, h)[:, None], index(width, w)[None, :]]


@dataclass
class Camera:
    colmap_id: int
    R: np.ndarray             # [3, 3] cam-to-world rotation (COLMAP qvec^T)
    T: np.ndarray             # [3] world-to-cam translation
    FoVx: float
    FoVy: float
    image: np.ndarray | None  # [3, H, W] float32 in [0, 1]
    image_name: str
    uid: int
    image_width: int = 0
    image_height: int = 0
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    znear: float = ZNEAR
    zfar: float = ZFAR

    world_view_transform: np.ndarray = field(init=False)
    projection_matrix: np.ndarray = field(init=False)
    full_proj_transform: np.ndarray = field(init=False)
    camera_center: np.ndarray = field(init=False)

    def __post_init__(self):
        if self.image is not None:
            self.image = np.clip(self.image, 0.0, 1.0).astype(np.float32)
            self.image_height, self.image_width = self.image.shape[-2:]
        w2c = cm.get_world_to_view(self.R, self.T, self.trans, self.scale)
        self.world_view_transform = w2c.T.astype(np.float32)
        self.projection_matrix = cm.get_projection_matrix(
            self.znear, self.zfar, self.FoVx, self.FoVy).T.astype(np.float32)
        self.full_proj_transform = (
            self.world_view_transform @ self.projection_matrix
        ).astype(np.float32)
        self.camera_center = np.linalg.inv(
            self.world_view_transform)[3, :3].astype(np.float32)

    @property
    def tanfovx(self) -> float:
        return math.tan(self.FoVx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.FoVy * 0.5)

    def get_language_feature(self, language_feature_dir: str,
                             feature_level: int):
        """(features [512, H, W] f32, mask [1, H, W] bool): each pixel's
        segment row, -1 masked (its row wraps to the last, as numpy's
        indexing and the native loader do)."""
        if not 0 <= feature_level <= 3:
            raise ValueError(f"feature_level={feature_level}")
        base = os.path.join(language_feature_dir, self.image_name)
        from .. import native

        out = native.load_language_feature(
            base + "_s.npy", base + "_f.npy", feature_level,
            self.image_height, self.image_width)
        if out is not None:
            return out
        seg_map = np.load(base + "_s.npy")
        feature_map = np.load(base + "_f.npy")
        H, W = self.image_height, self.image_width
        seg = seg_map[feature_level]
        if seg.shape != (H, W):
            seg = resize_nearest(seg, W, H)
        seg = seg.astype(np.int64)
        feat = np.transpose(feature_map[seg], (2, 0, 1)).astype(np.float32)
        return feat, (seg != -1)[None]

    def get_language_feature_compact(self, language_feature_dir: str,
                                     feature_level: int):
        """(segment feature table [S, 512] f32, segment map [H, W] int32,
        -1 = unassigned) for SAM level `feature_level` (0 = default, 1-3 =
        s, m, l)."""
        if not 0 <= feature_level <= 3:
            raise ValueError(f"feature_level={feature_level}")
        base = os.path.join(language_feature_dir, self.image_name)
        seg_map = np.load(base + "_s.npy")       # [4, h, w], -1 = unassigned
        feature_map = np.load(base + "_f.npy")   # [S, 512]
        H, W = self.image_height, self.image_width
        if seg_map.shape[1] != H or seg_map.shape[2] != W:
            seg_map = np.stack([resize_nearest(s, W, H) for s in seg_map])
        return (feature_map.astype(np.float32),
                seg_map[feature_level].astype(np.int32))


@dataclass
class MiniCam:
    """The viewer's camera (reference scene/cameras.py:98-110): the
    transposed world-view and full-projection matrices as given, the
    centre from the world-view matrix's inverse."""

    image_width: int
    image_height: int
    FoVy: float
    FoVx: float
    znear: float
    zfar: float
    world_view_transform: np.ndarray
    full_proj_transform: np.ndarray
    camera_center: np.ndarray = field(init=False)

    def __post_init__(self):
        self.camera_center = np.linalg.inv(self.world_view_transform)[3, :3]

    @property
    def tanfovx(self) -> float:
        return math.tan(self.FoVx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.FoVy * 0.5)
