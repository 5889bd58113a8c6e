"""The reference's torch checkpoints, `chkpnt*.pth`
(port of langsplatv2_tpu/models/torch_interop.py).

The reference persists training state as
``torch.save((gaussians.capture(include_feature), iteration), path)``: a
12-tuple in the geometry phase, a 14-tuple in the feature phase (language
logits and codebooks added), reference scene/gaussian_model.py:67-139 and
train.py:265-267. This module reads that tuple into the port's
GaussianModel (padded to a capacity), restores its torch Adam state_dict
into the port's named-group Adam (train/optimizers.py) and writes a model
back as the tuple.

The reference's geometry optimizer has one group a parameter, named xyz,
f_dc, f_rest, opacity, scaling, rotation; its feature optimizer has one
group, "language_feature", holding [logits, codebooks]. torch keys Adam
state by the global parameter index, so in both phases state index i is
the i-th parameter of that order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .gaussians import GaussianModel, _pad, _pad_rotation, compact

_RGB_GROUPS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
               "rotation")
_FEATURE_GROUPS = ("language_logits", "codebooks")
_REFERENCE_NAMES = {"f_dc": "features_dc", "f_rest": "features_rest"}


def _f32(t) -> torch.Tensor:
    """A tensor or array -> a float32 CPU tensor."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().float()
    return torch.from_numpy(np.asarray(t, np.float32))


def load_torch_checkpoint(path: str, capacity: int | None = None,
                          max_sh_degree: int = 3, device=None):
    """Read a reference ``chkpnt*.pth`` -> (model, iteration, opt_dict).
    The file is read onto the CPU, then the model moves to `device`;
    `opt_dict` is the tuple's raw torch Adam state_dict (for
    convert_torch_adam_state)."""
    dev = resolve_device(device)
    model_args, iteration = torch.load(path, map_location="cpu",
                                       weights_only=False)
    model, opt_dict = model_from_capture_tuple(
        model_args, capacity=capacity, max_sh_degree=max_sh_degree,
        device=dev)
    return model, int(iteration), opt_dict


def model_from_capture_tuple(model_args, capacity: int | None = None,
                             max_sh_degree: int = 3, device=None):
    """The reference capture() 12- or 14-tuple -> (GaussianModel,
    opt_dict). Rows past the tuple's count are dead padding (zero, identity
    rotations); empty densification statistics read as zeros."""
    dev = resolve_device(device)
    if len(model_args) == 14:
        (active_sh, xyz, f_dc, f_rest, scaling, rotation, opacity, logits,
         codebooks, max_radii2d, grad_accum, denom, opt_dict,
         spatial_lr_scale) = model_args
    elif len(model_args) == 12:
        (active_sh, xyz, f_dc, f_rest, scaling, rotation, opacity,
         max_radii2d, grad_accum, denom, opt_dict,
         spatial_lr_scale) = model_args
        logits = codebooks = None
    else:
        raise ValueError(
            f"unrecognized capture tuple length {len(model_args)} (expected "
            "12 or 14; reference gaussian_model.py:103-138)")
    n = _f32(xyz).shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < checkpoint rows {n}")

    def rows(t):
        return _pad(_f32(t), capacity).to(dev)

    def stat(t, shape):
        a = _f32(t)
        if a.numel() == 0:
            return torch.zeros((capacity,) + shape, device=dev)
        return rows(a.reshape((n,) + shape))

    live = torch.zeros(capacity, dtype=torch.bool, device=dev)
    live[:n] = True
    model = GaussianModel(
        xyz=rows(xyz), features_dc=rows(f_dc), features_rest=rows(f_rest),
        scaling=rows(scaling),
        rotation=_pad_rotation(_f32(rotation), capacity).to(dev),
        opacity=rows(opacity), live=live,
        language_logits=None if logits is None else rows(logits),
        codebooks=None if codebooks is None else _f32(codebooks).to(dev),
        max_radii2d=stat(max_radii2d, ()),
        xyz_gradient_accum=stat(grad_accum, (1,)), denom=stat(denom, (1,)),
        active_sh_degree=int(active_sh), max_sh_degree=max_sh_degree,
        spatial_lr_scale=float(spatial_lr_scale))
    return model, opt_dict


@torch.no_grad()
def convert_torch_adam_state(opt_dict: dict, optimizer: torch.optim.Adam,
                             capacity: int) -> torch.optim.Adam:
    """Load a reference torch Adam state_dict into the port's named-group
    Adam in place: moments padded with zero rows to `capacity` (codebooks
    keep their shape) and step counts. A group the state_dict does not
    hold keeps its state. Returns the optimizer."""
    if not opt_dict or not opt_dict.get("state"):
        return optimizer
    names = [g.get("name", "") for g in opt_dict.get("param_groups", [])]
    if names and names[0] == "language_feature":
        order = _FEATURE_GROUPS
    elif names:
        order = tuple(_REFERENCE_NAMES.get(nm, nm) for nm in names)
    else:
        order = _RGB_GROUPS
    params = {g["name"]: g["params"][0] for g in optimizer.param_groups}
    for idx, ours in enumerate(order):
        if ours not in params or idx not in opt_dict["state"]:
            continue
        p = params[ours]
        st = opt_dict["state"][idx]
        step = st.get("step", 0)
        step = float(step.item() if hasattr(step, "item") else step)
        moments = {}
        for key in ("exp_avg", "exp_avg_sq"):
            v = _f32(st[key])
            if ours != "codebooks" and v.shape[0] != capacity:
                v = _pad(v, capacity)
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{ours}: state {tuple(v.shape)}, "
                                 f"parameter {tuple(p.shape)}")
            moments[key] = v.to(p.device)
        optimizer.state[p] = {"step": torch.tensor(step, dtype=torch.float32),
                              **moments}
    return optimizer


def capture_tuple_from_model(model: GaussianModel, include_feature: bool,
                             opt_dict: dict | None = None):
    """GaussianModel -> the reference capture() tuple (CPU float32
    tensors, live rows only)."""
    m = compact(model)

    def t(x):
        return x.detach().cpu().float().clone()

    if opt_dict is None:
        opt_dict = {"state": {}, "param_groups": []}
    base = (int(m.active_sh_degree), t(m.xyz), t(m.features_dc),
            t(m.features_rest), t(m.scaling), t(m.rotation), t(m.opacity))
    stats = (t(m.max_radii2d), t(m.xyz_gradient_accum), t(m.denom))
    tail = stats + (opt_dict, float(m.spatial_lr_scale))
    if include_feature:
        if m.language_logits is None or m.codebooks is None:
            raise ValueError("model has no language features to capture")
        return base + (t(m.language_logits), t(m.codebooks)) + tail
    return base + tail


def save_torch_checkpoint(path: str, model: GaussianModel, iteration: int,
                          include_feature: bool | None = None,
                          opt_dict: dict | None = None) -> None:
    """Write a reference-loadable ``chkpnt*.pth``."""
    if include_feature is None:
        include_feature = model.language_logits is not None
    torch.save((capture_tuple_from_model(model, include_feature, opt_dict),
                int(iteration)), path)
