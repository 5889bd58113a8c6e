"""Grouped Adam with state surgery (port of
langsplatv2_tpu/train/optimizers.py).

The JAX package keeps one optax chain (`scale_by_adam` then a constant or
scheduled learning rate) per named parameter group; here the groups are
param groups of one `torch.optim.Adam`, named by a "name" key. optax's
scale_by_adam and torch's Adam make the same update, mu_hat / (sqrt(nu_hat)
+ eps), with beta = (0.9, 0.999) and eps = 1e-15 (the reference's). A
scheduled group carries its schedule as "lr_schedule"; `set_scheduled_lrs`
sets its rate for the coming step from the group's step count u as
schedule(u + 1), which is what optax's scale_by_schedule(count + 1) gives.

Densification replaces the parameter tensors; `rebind` points the groups
at the new ones and carries the Adam state over, with zero rows where the
capacity grew (the reference's cat_tensors_to_optimizer appends zero
state). `zero_moment_rows` and `zero_group_moments` are the JAX package's
surgery for reused slots and the opacity reset.
"""
from __future__ import annotations

from typing import Callable

import torch

ADAM_EPS = 1e-15
BETAS = (0.9, 0.999)


def grouped_adam(groups: dict[str, tuple[torch.Tensor, float | Callable]]
                 ) -> torch.optim.Adam:
    """{name: (parameter, learning rate or schedule step -> rate)} -> Adam
    with one param group per name."""
    param_groups = []
    for name, (p, lr) in groups.items():
        group = {"params": [p], "name": name}
        if callable(lr):
            group.update(lr=lr(1), lr_schedule=lr)
        else:
            group["lr"] = lr
        param_groups.append(group)
    return torch.optim.Adam(param_groups, betas=BETAS, eps=ADAM_EPS)


def _step_count(optimizer, p) -> int:
    state = optimizer.state.get(p)
    return int(state["step"]) if state and "step" in state else 0


def set_scheduled_lrs(optimizer: torch.optim.Optimizer) -> None:
    """Set each scheduled group's rate for its next update."""
    for group in optimizer.param_groups:
        if "lr_schedule" in group:
            u = _step_count(optimizer, group["params"][0])
            group["lr"] = group["lr_schedule"](u + 1)


@torch.no_grad()
def zero_moment_rows(optimizer: torch.optim.Optimizer, mask) -> None:
    """Zero both Adam moments on rows where mask [C] is True, in every
    group whose parameter has C rows."""
    for group in optimizer.param_groups:
        (p,) = group["params"]
        state = optimizer.state.get(p)
        if not state or p.shape[0] != mask.shape[0]:
            continue
        shaped = mask.reshape((-1,) + (1,) * (p.dim() - 1))
        for key in ("exp_avg", "exp_avg_sq"):
            state[key].masked_fill_(shaped, 0.0)


@torch.no_grad()
def zero_group_moments(optimizer: torch.optim.Optimizer, name: str) -> None:
    """Zero both moments of one named group; its step count stays."""
    for group in optimizer.param_groups:
        if group["name"] == name:
            state = optimizer.state.get(group["params"][0])
            if state:
                state["exp_avg"].zero_()
                state["exp_avg_sq"].zero_()
            return
    raise KeyError(name)


@torch.no_grad()
def rebind(optimizer: torch.optim.Optimizer,
           params: dict[str, torch.Tensor]) -> None:
    """Point each named group at params[name], carrying its Adam state;
    moments gain zero rows where the new tensor has more rows."""
    for group in optimizer.param_groups:
        (old,) = group["params"]
        new = params[group["name"]]
        state = optimizer.state.pop(old, None)
        if state:
            for key in ("exp_avg", "exp_avg_sq"):
                v = state[key]
                extra = new.shape[0] - v.shape[0]
                if extra < 0:
                    raise ValueError(f"{group['name']}: {new.shape[0]} rows "
                                     f"< {v.shape[0]} in the optimizer")
                if extra:
                    state[key] = torch.cat(
                        [v, v.new_zeros((extra,) + tuple(v.shape[1:]))])
            optimizer.state[new] = state
        group["params"] = [new]
