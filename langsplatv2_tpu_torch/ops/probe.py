"""K9: the elementwise cell-chain probe (port of
scripts/profile_vpu_bf16.py::kernel, pallas_call at :53).

Not part of the system's path: a probe of the card's elementwise rates in
f32 against bf16, the question behind K2's bf16 cell math
(`bf16_cells`). Each element runs REPS repetitions of
    a = x * 1/2;  e = exp(-a * a);
    m = (f32(e) <= 0.999) & (f32(a) >= -0.999);
    acc += m ? e : 1/2;  x += e * step(1e-3)
in `dtype` (the compares in f32 on the values rounded to dtype, as JAX
does); the output is acc in f32. On a CUDA tensor `cell_chain` launches
csrc/probe.cu (f32: a thread an element; bf16: a thread a bf16x2 pair
on packed instructions, its exp through ex2.approx where that provably
rounds as expf does, else expf), on a CPU tensor it runs
`cell_chain_plain`, the same chain in torch ops on a `dtype` tensor (XLA's
bf16 semantics: each mul and add rounded to bf16, exp computed in f32 and
rounded).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import kernels

REPS = 64
LIM = float(np.float32(0.999))          # JAX's jnp.float32(0.999)
# The largest bf16 value not above LIM (the next is 1.0): on bf16 values,
# f32(v) <= LIM is v <= BF16_LIM and f32(v) >= -LIM is v >= -BF16_LIM, the
# packed compares of the bf16 kernel.
BF16_LIM = 0.99609375
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/probe.cu's modes besides DTYPES': 2 the ex2.approx.bf16x2 what-if
# (not K9's arithmetic), 3 the bf16 form's exp(-s) alone on s pairs.
WHAT_IF, EXP_ONLY = 2, 3


def cell_chain_plain(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """x [..., 256, 256] f32 -> acc f32, the chain in torch ops."""
    x = x.to(dtype)
    half = torch.tensor(0.5, dtype=dtype, device=x.device)
    step = torch.tensor(1e-3, dtype=dtype, device=x.device)
    acc = torch.zeros_like(x)
    for _ in range(REPS):
        a = x * half
        e = torch.exp(-a * a)
        m = (e.float() <= LIM) & (a.float() >= -LIM)
        acc = acc + torch.where(m, e, half)
        x = x + e * step
    return acc.float()


def cell_chain(x, dtype=torch.float32, *, device=None) -> torch.Tensor:
    """The probe on `x` (f32, any shape with an even element count): CUDA
    unless device="cpu". `launches` counts kernel launches."""
    if dtype not in DTYPES:
        raise ValueError(f"cell_chain: dtype {dtype} is not f32 or bf16")
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        return cell_chain_plain(x, dtype)
    if dev.type != "cuda":
        raise ValueError(f"cell_chain: unsupported device {dev}")
    x = x.contiguous()
    n = x.numel()
    if n % 2:
        raise ValueError(f"cell_chain: {n} elements, need an even count")
    out = torch.empty_like(x)
    kernels.launch("lsv2_cell_chain", kernels.ptr(x), kernels.ptr(out), n,
                   DTYPES[dtype], kernels.NULL, kernels.stream(x))
    cell_chain.launches += 1
    return out


cell_chain.launches = 0


def kernel_mode(x: torch.Tensor, mode: int):
    """csrc/probe.cu in `mode` on a CUDA tensor x (f32, an even element
    count), not counted in `launches`: (out, the pairs that fell back to
    expf: in mode 1 the pairs whose chain ran again with expf, in
    EXP_ONLY the pairs whose exp did; 0 in modes 0 and WHAT_IF)."""
    if x.device.type != "cuda":
        raise ValueError("kernel_mode runs the CUDA kernel only")
    x = x.contiguous()
    out = torch.empty_like(x)
    stats = torch.zeros(1, dtype=torch.int64, device=x.device)
    kernels.launch("lsv2_cell_chain", kernels.ptr(x), kernels.ptr(out),
                   x.numel(), mode, kernels.ptr(stats), kernels.stream(x))
    return out, int(stats[0])
