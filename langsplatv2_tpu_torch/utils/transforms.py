"""Rotations, covariance and parameter activations
(port of langsplatv2_tpu/utils/transforms.py)."""
from __future__ import annotations

import torch


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternions [..., 4] (w, x, y, z), normalized here -> [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    r, x, y, z = q.unbind(-1)
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))


def covariance_from_scaling_rotation(scaling: torch.Tensor,
                                     scaling_modifier: float,
                                     q: torch.Tensor) -> torch.Tensor:
    """Sigma = L L^T with L = R diag(s), as [..., 6] = xx xy xz yy yz zz."""
    L = quat_to_rotmat(q) * (scaling_modifier * scaling)[..., None, :]
    cov = L @ L.transpose(-1, -2)
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], -1)


def scaling_activation(s):
    return torch.exp(s)


def rotation_activation(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def opacity_activation(o):
    """1 / (1 + exp(-x)), written out as the reference writes it."""
    return 1.0 / (1.0 + torch.exp(-o))
