"""Device resolution shared by the port's entry points.

No JAX counterpart: JAX places arrays on its default backend. The port
runs on CUDA unless the caller asks for the CPU, and never drops to the CPU
on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. Raises when CUDA is asked for but unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return dev
