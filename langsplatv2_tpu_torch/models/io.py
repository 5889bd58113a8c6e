"""Model persistence: 3DGS PLY export/import and full checkpoints
(port of langsplatv2_tpu/models/io.py:26-130, 171-185).

- PLY in the reference schema (scene/gaussian_model.py:269-350): x y z,
  nx ny nz, f_dc_*, f_rest_* channel-major, opacity, scale_*, rot_*.
- Checkpoints in the JAX package's `.npz` format: `model/<field>` arrays
  by name, a JSON `manifest`, and the optimizer state as `opt/<i>` leaves
  in the order `jax.tree_util.tree_flatten` gives the JAX grouped optimizer
  state: groups by sorted name, each (count, mu, nu) of optax's
  scale_by_adam, plus the schedule's count for a group whose learning rate
  is scheduled (the port's groups that carry an "lr_schedule"). A geometry
  the port trains thus loads in the JAX package, and the reverse.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..scene import ply as plyio
from .gaussians import (BUFFER_FIELDS, PARAM_FIELDS, GaussianModel, _pad,
                        _pad_rotation, compact, from_numpy_params)


def save_ply(model: GaussianModel, path: str) -> None:
    m = compact(model)
    n = m.capacity

    def arr(t):
        return t.detach().cpu().numpy().astype(np.float32)

    xyz = arr(m.xyz)
    f_dc = arr(m.features_dc).transpose(0, 2, 1).reshape(n, -1)
    f_rest = arr(m.features_rest).transpose(0, 2, 1).reshape(n, -1)
    opacity, scale, rot = arr(m.opacity), arr(m.scaling), arr(m.rotation)
    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(scale.shape[1])]
             + [f"rot_{i}" for i in range(rot.shape[1])])
    attrs = np.concatenate(
        [xyz, np.zeros_like(xyz), f_dc, f_rest, opacity, scale, rot], axis=1)
    rec = np.rec.fromarrays(attrs.T, names=names, formats=["<f4"] * len(names))
    plyio.write_ply(path, np.asarray(rec))


def load_ply(path: str, max_sh_degree: int = 3, capacity: int | None = None,
             device=None) -> GaussianModel:
    """All SH degrees active. Padding rows (capacity > count) get identity
    rotations (the JAX reader leaves them zero)."""
    dev = resolve_device(device)
    data = plyio.read_ply(path)["vertex"]
    n = len(data)
    n_coef = (max_sh_degree + 1) ** 2

    def sorted_fields(prefix):
        names = sorted((p for p in data.dtype.names if p.startswith(prefix)),
                       key=lambda x: int(x.split("_")[-1]))
        return np.stack([data[p] for p in names], axis=1).astype(np.float32)

    rest = sorted_fields("f_rest_")
    if rest.shape[1] != 3 * (n_coef - 1):
        raise ValueError(f"{path}: {rest.shape[1]} f_rest fields, expected "
                         f"{3 * (n_coef - 1)} for SH degree {max_sh_degree}")
    xyz = np.stack([data["x"], data["y"], data["z"]], 1).astype(np.float32)
    fields = dict(
        xyz=xyz,
        features_dc=np.stack([data[f"f_dc_{i}"] for i in range(3)],
                             1).astype(np.float32)[:, None, :],
        features_rest=rest.reshape(n, 3, n_coef - 1).transpose(0, 2, 1),
        scaling=sorted_fields("scale_"), rotation=sorted_fields("rot"),
        opacity=np.asarray(data["opacity"], np.float32)[:, None])
    capacity = capacity or n
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in fields.items()}
    live = torch.zeros(capacity, dtype=torch.bool, device=dev)
    live[:n] = True
    return GaussianModel(
        **{k: (_pad_rotation if k == "rotation" else _pad)(v, capacity)
           for k, v in t.items()},
        live=live, active_sh_degree=max_sh_degree, max_sh_degree=max_sh_degree)


def _optimizer_leaves(optimizer: torch.optim.Optimizer | None) -> list:
    """The optimizer state as the JAX package's flattened leaves."""
    if optimizer is None:
        return []
    leaves = []
    for group in sorted(optimizer.param_groups, key=lambda g: g["name"]):
        (p,) = group["params"]
        state = optimizer.state.get(p, {})
        count = np.int32(int(state["step"]) if "step" in state else 0)
        for key in ("exp_avg", "exp_avg_sq"):
            if key not in state:
                state = dict(state, **{key: torch.zeros_like(p)})
        leaves += [count, state["exp_avg"], state["exp_avg_sq"]]
        if "lr_schedule" in group:
            leaves.append(count)
    return [np.asarray(v.detach().cpu()) if torch.is_tensor(v) else v
            for v in leaves]


def save_checkpoint(path: str, model: GaussianModel,
                    optimizer: torch.optim.Optimizer | None, iteration: int,
                    extra: dict | None = None) -> None:
    """Model fields by name, the optimizer's Adam state as JAX leaves, the
    iteration and `extra`."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"model/{name}": v.detach().cpu().numpy()
              for name, v in model.fields().items() if v is not None}
    if "model/quick_indices" in arrays:       # the JAX model's dtype
        arrays["model/quick_indices"] = arrays["model/quick_indices"].astype(
            np.float32)
    opt = _optimizer_leaves(optimizer)
    for i, leaf in enumerate(opt):
        arrays[f"opt/{i}"] = leaf
    manifest = {
        "iteration": int(iteration), "num_opt_leaves": len(opt),
        "active_sh_degree": model.active_sh_degree,
        "max_sh_degree": model.max_sh_degree,
        "spatial_lr_scale": model.spatial_lr_scale,
        "include_feature": model.language_logits is not None,
        "extra": extra or {},
    }
    np.savez(path, manifest=json.dumps(manifest), **arrays)


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


def load_optimizer_state(path: str, optimizer: torch.optim.Optimizer) -> None:
    """Restore the Adam state of each named group from the checkpoint's
    `opt/<i>` leaves (the layout `save_checkpoint` writes and the JAX
    package's grouped optimizer has). Raises when the layout differs."""
    with np.load(path, allow_pickle=False) as data:
        n = json.loads(str(data["manifest"]))["num_opt_leaves"]
        leaves = [data[f"opt/{i}"] for i in range(n)]
    groups = sorted(optimizer.param_groups, key=lambda g: g["name"])
    want = sum(4 if "lr_schedule" in g else 3 for g in groups)
    if len(leaves) != want:
        raise ValueError(f"{path}: {len(leaves)} optimizer leaves, the "
                         f"optimizer's groups need {want}")
    i = 0
    for group in groups:
        (p,) = group["params"]
        count, mu, nu = leaves[i:i + 3]
        i += 4 if "lr_schedule" in group else 3
        if mu.shape != tuple(p.shape):
            raise ValueError(f"{group['name']}: state {mu.shape}, parameter "
                             f"{tuple(p.shape)}")
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(mu).to(p.device),
            "exp_avg_sq": torch.from_numpy(nu).to(p.device)}
