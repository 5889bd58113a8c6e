"""Camera and projection math (numpy copy of langsplatv2_tpu/utils/camera_math.py).

Conventions of the reference `utils/graphics_utils.py`: world->view
matrices are stored transposed (row-vector convention), the projection
maps z into [0, 1], and full_proj_transform = world_view @ projection.T.
"""
from __future__ import annotations

import math

import numpy as np


def get_world_to_view(R: np.ndarray, t: np.ndarray,
                      translate: np.ndarray | None = None,
                      scale: float = 1.0) -> np.ndarray:
    """4x4 world-to-camera matrix; `R` is camera-to-world as COLMAP stores it."""
    if translate is None:
        translate = np.zeros(3)
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
    return np.float32(np.linalg.inv(C2W))


def get_projection_matrix(znear: float, zfar: float, fov_x: float,
                          fov_y: float) -> np.ndarray:
    """Perspective projection with z in [0, 1]."""
    top = math.tan(fov_y / 2) * znear
    right = math.tan(fov_x / 2) * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def ndc_to_pixel(ndc, size):
    """NDC in [-1, 1] -> continuous pixel coordinate (CUDA ndc2Pix)."""
    return ((ndc + 1.0) * size - 1.0) * 0.5
