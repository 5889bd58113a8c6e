"""The top-k codes of the feature step on the card: csrc/topk_codes.cu's
forward (one launch for all the levels of [N, L*K] logits) and backward
(one launch writing d(logits)), and `TopkCodes`, the autograd node over
both. `utils/sparse_codes.py::get_weights_and_indices` routes CUDA tensors
here and every other tensor to its plain path, whose outputs the kernel's
equal on the card (indices bit for bit, the weights and the gradient as
PyTorch's softmax rounds them). The counter "topk_codes.launches"
(tracing.py) counts the launches, forward and backward.

It replaces no Pallas kernel: the JAX top-k is XLA code
(langsplatv2_tpu/utils/sparse_codes.py).
"""
from __future__ import annotations

import torch

from .. import tracing
from . import kernels

MAX_TOPK = 16   # the largest k csrc/topk_codes.cu takes


def _check_codes_shape(logits: torch.Tensor, k: int, levels: int) -> int:
    """K, after raising on what csrc/topk_codes.cu does not take."""
    if logits.dtype != torch.float32:
        raise TypeError(f"top-k codes: logits of dtype {logits.dtype}; the "
                        "kernel takes float32")
    if logits.dim() != 2 or levels < 1 or logits.shape[1] % levels:
        raise ValueError(f"top-k codes: logits {tuple(logits.shape)} are not "
                         f"[N, levels * K] with levels = {levels}")
    K = logits.shape[1] // levels
    if not 1 <= k <= min(K, MAX_TOPK):
        raise ValueError(f"top-k codes: k = {k} outside 1..min(K, "
                         f"{MAX_TOPK}) at K = {K}")
    return K


def topk_codes_kernel(logits: torch.Tensor, k: int, levels: int = 1):
    """One launch of csrc/topk_codes.cu's forward on CUDA logits (no
    autograd): `utils/sparse_codes.py::get_weights_and_indices_plain`'s
    outputs."""
    K = _check_codes_shape(logits, k, levels)
    x = logits.detach().contiguous()
    n = x.shape[0]
    weights = torch.empty((n, levels * k), dtype=torch.float32,
                          device=x.device)
    indices = torch.empty((n, levels * k), dtype=torch.int64,
                          device=x.device)
    if n:
        P = kernels.ptr
        kernels.launch("lsv2_topk_codes", P(x), n * levels, K, levels, k,
                       P(weights), P(indices), kernels.stream(x))
        tracing.count("topk_codes.launches")
    return weights, indices


def topk_codes_backward_kernel(d_weights: torch.Tensor,
                               weights: torch.Tensor, indices: torch.Tensor,
                               K: int, levels: int) -> torch.Tensor:
    """One launch of csrc/topk_codes.cu's backward: d(logits) [N,
    levels*K], a fresh tensor, from d(weights) and the forward's outputs:
    w_j (g_j - sum_i w_i g_i) summed over each selected column's entries,
    exactly 0 in every other column."""
    n, lk = weights.shape
    k = lk // levels
    dev = weights.device
    g = d_weights.detach().to(torch.float32).contiguous()
    for t, name, dtype in ((g, "d_weights", torch.float32),
                           (weights, "weights", torch.float32),
                           (indices, "indices", torch.int64)):
        kernels.check_tensor(t, name, dtype, (n, lk), dev)
    d_logits = torch.empty((n, levels * K), dtype=torch.float32, device=dev)
    if n:
        P = kernels.ptr
        kernels.launch("lsv2_topk_codes_bwd", P(g), P(weights), P(indices),
                       n * levels, K, levels, k, P(d_logits),
                       kernels.stream(d_logits))
        tracing.count("topk_codes.launches")
    return d_logits


class TopkCodes(torch.autograd.Function):
    """The kernel's forward and backward as one autograd node over the whole
    [N, levels*K] logits (the indices carry no gradient)."""

    @staticmethod
    def forward(ctx, logits, k: int, levels: int):
        weights, indices = topk_codes_kernel(logits, k, levels)
        ctx.save_for_backward(weights, indices)
        ctx.mark_non_differentiable(indices)
        ctx.set_materialize_grads(False)   # no zero fill for d(indices)
        ctx.K, ctx.levels = logits.shape[1] // levels, levels
        return weights, indices

    @staticmethod
    def backward(ctx, d_weights, _d_indices):
        weights, indices = ctx.saved_tensors
        return (topk_codes_backward_kernel(d_weights, weights, indices,
                                           ctx.K, ctx.levels), None, None)
