"""Learning-rate schedules (port of langsplatv2_tpu/utils/schedules.py).

The reference's log-linear decay with an optional sine warm-up delay
(utils/general_utils.py:29-62). The JAX version is traceable for optax;
here the rate is set on the host before each optimizer step, so plain
Python floats are enough.
"""
from __future__ import annotations

import math


def expon_lr_func(lr_init: float, lr_final: float, lr_delay_steps: int = 0,
                  lr_delay_mult: float = 1.0, max_steps: int = 1_000_000):
    """step -> learning rate: 0 before step 0 or when both ends are 0."""
    def helper(step) -> float:
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
        else:
            delay_rate = 1.0
        t = min(max(step / max_steps, 0.0), 1.0)
        return delay_rate * math.exp(math.log(lr_init) * (1 - t)
                                     + math.log(lr_final) * t)

    return helper
