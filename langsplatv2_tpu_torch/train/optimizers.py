"""Grouped Adam (port of langsplatv2_tpu/train/optimizers.py).

The JAX package keeps one optax chain (`scale_by_adam` then a constant
learning rate) per named parameter group; here the groups are param groups
of one `torch.optim.Adam`, named by a "name" key. optax's scale_by_adam and
torch's Adam make the same update, mu_hat / (sqrt(nu_hat) + eps), with
beta = (0.9, 0.999) and eps = 1e-15 (the reference's). Moment surgery for
densify (`zero_moment_rows`, `zero_group_moments`) and scheduled learning
rates belong to the geometry slice.
"""
from __future__ import annotations

import torch

ADAM_EPS = 1e-15
BETAS = (0.9, 0.999)


def grouped_adam(groups: dict[str, tuple[torch.Tensor, float]]
                 ) -> torch.optim.Adam:
    """{name: (parameter, learning rate)} -> Adam with one param group per
    name."""
    return torch.optim.Adam(
        [{"params": [p], "lr": lr, "name": name}
         for name, (p, lr) in groups.items()],
        betas=BETAS, eps=ADAM_EPS)
