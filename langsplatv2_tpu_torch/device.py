"""Device resolution shared by the port's entry points.

No JAX counterpart: JAX places arrays on its default backend. The port
runs on CUDA unless the caller asks for the CPU, and never drops to the CPU
on its own.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. Raises when CUDA is asked for but unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return dev


@contextmanager
def no_tf32_matmul():
    """f32 matrix products without TF32 inside the block (exact where the
    operands and every partial sum are exact in f32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
