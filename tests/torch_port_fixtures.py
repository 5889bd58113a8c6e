"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_port_*.py).

Scenes are made with numpy from a seed and handed to both the JAX
reference and the port, so the two sides see identical float32 inputs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from langsplatv2_tpu_torch.utils.camera_math import (get_projection_matrix,
                                                     get_world_to_view)


def camera(h: int, w: int):
    """The bench camera: identity pose, 60 degree vertical field of view.
    Returns (view [4,4], proj [4,4], tanfovx, tanfovy) as float32 numpy."""
    fovy = math.radians(60)
    fovx = 2 * math.atan(math.tan(fovy / 2) * w / h)
    w2c = get_world_to_view(np.eye(3), np.zeros(3))
    view = np.asarray(w2c.T, np.float32)
    proj = np.asarray(w2c.T @ get_projection_matrix(0.01, 100, fovx, fovy).T,
                      np.float32)
    return view, proj, math.tan(fovx / 2), math.tan(fovy / 2)


def scene(n: int, seed: int = 0) -> dict:
    """Random splats in front of the bench camera (test_pallas_kernels.py
    `_scene` distribution): means, scales, rotations, opacities [n, 1],
    colors."""
    rng = np.random.default_rng(seed)
    return dict(
        means=np.concatenate([rng.uniform(-2, 2, (n, 2)),
                              rng.uniform(1.0, 8.0, (n, 1))], 1
                             ).astype(np.float32),
        scales=rng.uniform(0.02, 0.3, (n, 3)).astype(np.float32),
        rotations=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(0.1, 0.95, (n, 1)).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
    )


def quick_pairs(n: int, levels: int = 3, k: int = 64, topk: int = 4,
                seed: int = 3):
    """Merged-model quick pairs: [n, levels*topk] weights summing to 1 and
    float32 indices, level l's in [l*k, (l+1)*k) (bench.py:246-250)."""
    rng = np.random.default_rng(seed)
    qw = rng.uniform(0, 1, (n, levels * topk)).astype(np.float32)
    qw /= qw.sum(1, keepdims=True)
    qi = np.concatenate([rng.integers(0, k, (n, topk)) + lvl * k
                         for lvl in range(levels)], 1).astype(np.float32)
    return qw, qi


def model_fields(n: int, seed: int = 0, levels: int = 3, k: int = 64,
                 dim: int = 512, topk: int = 4) -> dict:
    """Raw GaussianModel fields (langsplatv2_tpu/models/io.py MODEL_FIELDS)
    of a merged quick model at SH degree 0."""
    sc = scene(n, seed)
    rng = np.random.default_rng(seed + 100)
    qw, qi = quick_pairs(n, levels, k, topk, seed + 200)
    op = sc["opacities"]
    return dict(
        xyz=sc["means"],
        features_dc=((sc["colors"] - 0.5) / 0.28209479177387814
                     ).astype(np.float32)[:, None, :],
        features_rest=np.zeros((n, 0, 3), np.float32),
        scaling=np.log(sc["scales"]).astype(np.float32),
        rotation=sc["rotations"],
        opacity=np.log(op / (1 - op)).astype(np.float32),
        live=np.ones(n, bool),
        codebooks=rng.normal(size=(levels, k, dim)).astype(np.float32),
        quick_weights=qw,
        quick_indices=qi,
    )


def within_one_bf16_ulp(a, b, slack):
    """|a - b| <= one bf16 ulp of b + slack, elementwise."""
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=1e-30))) - 7)
    return bool(((a - b).abs() <= ulp + slack).all())
