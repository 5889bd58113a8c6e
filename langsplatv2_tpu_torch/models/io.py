"""Native checkpoint reader (port of langsplatv2_tpu/models/io.py:105-185).

Reads the `.npz` that the JAX `save_checkpoint` writes: `model/<field>`
arrays plus a JSON `manifest`, with numpy alone. Optimizer state is not
read (the training slice needs it); the reference `.pth` reader and PLY
export are later work.
"""
from __future__ import annotations

import json

import numpy as np

from .gaussians import BUFFER_FIELDS, PARAM_FIELDS, GaussianModel, \
    from_numpy_params


def load_checkpoint(path: str, device=None) -> tuple[GaussianModel, int]:
    """Returns (model, iteration)."""
    with np.load(path, allow_pickle=False) as data:
        manifest = json.loads(str(data["manifest"]))
        fields = {f: data[f"model/{f}"] for f in PARAM_FIELDS + BUFFER_FIELDS
                  if f"model/{f}" in data}
    model = from_numpy_params(
        fields, active_sh_degree=manifest["active_sh_degree"],
        max_sh_degree=manifest["max_sh_degree"],
        spatial_lr_scale=manifest["spatial_lr_scale"], device=device)
    return model, int(manifest["iteration"])
