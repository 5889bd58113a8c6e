"""Colormap helpers for qualitative eval outputs (the port's own numpy
copy of langsplatv2_tpu/eval/colormaps.py; reference `eval/colormaps.py`,
nerfstudio-derived): `apply_colormap`, `apply_float_colormap` (turbo
default), `apply_depth_colormap`, `apply_pca_colormap` with outlier
rejection, and the `ColormapOptions` bundle used by the eval drivers.
matplotlib (float colormaps) and cv2 (saving) are imported when used.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _mpl_colormap(name: str, values: np.ndarray) -> np.ndarray:
    import matplotlib

    return matplotlib.colormaps[name](values)[..., :3]


@dataclass
class ColormapOptions:
    colormap: str = "default"
    normalize: bool = False
    colormap_min: float = 0.0
    colormap_max: float = 1.0
    invert: bool = False


def apply_float_colormap(image: np.ndarray, colormap: str = "turbo") -> np.ndarray:
    """[H, W, 1] float in [0,1] -> [H, W, 3] rgb."""
    if colormap == "gray":
        return np.repeat(image, 3, axis=-1)
    image = np.nan_to_num(image)
    if colormap == "default":
        colormap = "turbo"
    vals = np.clip(image[..., 0], 0, 1)
    return _mpl_colormap(colormap, vals).astype(np.float32)


def apply_colormap(image: np.ndarray,
                   colormap_options: ColormapOptions = ColormapOptions(),
                   eps: float = 1e-9) -> np.ndarray:
    """Dispatch on channel count: 3 = rgb passthrough, 1 float = colormap,
    1 bool = gray (reference apply_colormap)."""
    if image.shape[-1] == 3:
        return image
    if image.dtype == bool:
        return np.repeat(image.astype(np.float32), 3, axis=-1)
    if image.shape[-1] == 1 and np.issubdtype(image.dtype, np.floating):
        output = image
        if colormap_options.normalize:
            output = output - np.min(output)
            output = output / (np.max(output) + eps)
        output = output * (colormap_options.colormap_max -
                           colormap_options.colormap_min) + colormap_options.colormap_min
        output = np.clip(output, 0, 1)
        if colormap_options.invert:
            output = 1 - output
        return apply_float_colormap(output, colormap_options.colormap)
    raise NotImplementedError(f"colormap for shape {image.shape} / {image.dtype}")


def apply_depth_colormap(
    depth: np.ndarray,
    accumulation: np.ndarray | None = None,
    near_plane: float | None = None,
    far_plane: float | None = None,
    colormap_options: ColormapOptions = ColormapOptions(colormap="turbo"),
) -> np.ndarray:
    near_plane = near_plane if near_plane is not None else float(np.min(depth))
    far_plane = far_plane if far_plane is not None else float(np.max(depth))
    depth = (depth - near_plane) / (far_plane - near_plane + 1e-10)
    depth = np.clip(depth, 0, 1)
    colored = apply_colormap(depth, colormap_options)
    if accumulation is not None:
        colored = colored * accumulation + (1 - accumulation)
    return colored


def apply_pca_colormap(image: np.ndarray,
                       pca_mat: np.ndarray | None = None,
                       ignore_zeros: bool = True) -> np.ndarray:
    """Project [H, W, D] features to 3 PCA components with the reference's
    median-absolute-deviation outlier rejection, rescaled to [0, 1]."""
    H, W, D = image.shape
    flat = image.reshape(-1, D)
    valids = np.abs(flat).sum(-1) > 0 if ignore_zeros else np.ones(len(flat), bool)
    if pca_mat is None:
        sample = flat[valids]
        sample = sample - sample.mean(0, keepdims=True)
        _, _, vt = np.linalg.svd(sample[np.random.default_rng(0).permutation(
            len(sample))[:50000]], full_matrices=False)
        pca_mat = vt[:3].T  # [D, 3]
    projected = flat @ pca_mat  # [HW, 3]

    sub = projected[valids]
    d = np.abs(sub - np.median(sub, axis=0, keepdims=True))
    mdev = np.median(d, axis=0, keepdims=True)
    s = d / (mdev + 1e-10)
    rins = s[:, 0] < 3
    gins = s[:, 1] < 3
    bins_ = s[:, 2] < 3
    keep = rins & gins & bins_
    mins = sub[keep].min(0)
    maxs = sub[keep].max(0)
    sub = (sub - mins) / (maxs - mins + 1e-10)
    out = np.zeros_like(projected)
    out[valids] = sub
    return np.clip(out, 0, 1).reshape(H, W, 3)


def colormap_saving(image: np.ndarray, colormap_options: ColormapOptions,
                    save_path: str | None = None) -> np.ndarray:
    """Apply + optionally write to disk (reference eval/utils.py:73-88)."""
    out = apply_colormap(image, colormap_options)
    if save_path is not None:
        import cv2
        import os

        os.makedirs(os.path.dirname(str(save_path)) or ".", exist_ok=True)
        cv2.imwrite(str(save_path),
                    (out[..., ::-1] * 255).astype(np.uint8))
    return out
