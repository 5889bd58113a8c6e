"""Matrix products at the reference's precision ("f32": TF32 off) or at
the control's ("tf32": operands rounded to TF32's 10-bit mantissa, round
to nearest, ties away, and summed in f32, which is what a TF32 tensor
core does), on any device."""
from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (ties away from zero), as f32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with TF32 operands, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        return torch.matmul(ra, rb)

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32_round(g)
        return (torch.matmul(rg, rb.transpose(-1, -2)),
                torch.matmul(ra.transpose(-1, -2), rg))


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b at `prec`: "f32" or "tf32"."""
    if prec == "tf32":
        return _TF32MatMul.apply(a, b)
    if prec != "f32":
        raise ValueError(f"unknown precision {prec!r}")
    return torch.matmul(a, b)


def no_tf32():
    """Turn TF32 off for the process's f32 matrix products and
    convolutions (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
