"""Training losses: L1, L2, cosine, SSIM, MSE, PSNR (port of
langsplatv2_tpu/utils/losses.py).

SSIM is the reference's 11x11 Gaussian window (sigma 1.5) with same
padding (utils/loss_utils.py:41-71). Its five window filters run as one
depthwise `F.conv2d`, which the JAX package also left to the library
(`lax.conv`, not Pallas). cuDNN runs a float32 convolution in TF32 by
default, which keeps about three decimal digits; `_WindowFilter` turns
TF32 off around both its forward and its backward, so SSIM is computed in
full float32 whatever the process has set.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn.functional as F


def l1_loss(pred, gt):
    return (pred - gt).abs().mean()


def l2_loss(pred, gt):
    return ((pred - gt) ** 2).mean()


def safe_norm(x, dim, eps: float = 1e-8):
    """L2 norm along `dim`, clamped below at eps, with a finite gradient at
    a zero vector: sqrt'(0) would send NaN through the clamp, so a zero
    vector's norm takes the constant branch and carries no gradient."""
    sq = (x * x).sum(dim=dim)
    nonzero = sq > 0
    safe = torch.sqrt(torch.where(nonzero, sq, 1.0))
    return torch.clamp(torch.where(nonzero, safe, 0.0), min=eps)


def cos_loss(pred, gt, dim: int = 0, eps: float = 1e-8):
    """1 - mean cosine similarity along `dim` (reference
    loss_utils.py:24-25), each norm clamped below at eps as
    torch.nn.functional.cosine_similarity clamps it."""
    sim = (pred * gt).sum(dim=dim) / (safe_norm(pred, dim, eps)
                                      * safe_norm(gt, dim, eps))
    return 1.0 - sim.mean()


def mse(pred, gt):
    """Per-image MSE over flattened pixels, keeping the leading dim."""
    return ((pred - gt) ** 2).reshape(pred.shape[0], -1).mean(1, keepdim=True)


def psnr(pred, gt):
    return 20 * torch.log10(1.0 / torch.sqrt(mse(pred, gt)))


def gaussian_window(window_size: int, sigma: float, device=None):
    """[window_size, window_size] normalized outer product, float32."""
    xs = torch.arange(window_size, dtype=torch.float32, device=device)
    g = torch.exp(-((xs - window_size // 2) ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g)


@contextmanager
def _no_tf32_convolutions():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _WindowFilter(torch.autograd.Function):
    """Depthwise same-padded correlation of x [B, C, H, W] with a
    symmetric window [C, 1, k, k]; its adjoint is the same correlation."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(kernel)
        with _no_tf32_convolutions():
            return F.conv2d(x, kernel, padding=kernel.shape[-1] // 2,
                            groups=x.shape[1])

    @staticmethod
    def backward(ctx, g):
        (kernel,) = ctx.saved_tensors
        with _no_tf32_convolutions():
            return F.conv2d(g, kernel, padding=kernel.shape[-1] // 2,
                            groups=g.shape[1]), None


def ssim(img1, img2, window_size: int = 11, size_average: bool = True):
    """SSIM over [C, H, W] or [B, C, H, W] images."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    c = img1.shape[-3]
    window = gaussian_window(window_size, 1.5, img1.device).to(img1.dtype)
    stack = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], 1)
    kernel = window[None, None].expand(5 * c, 1, window_size,
                                       window_size).contiguous()
    mu1, mu2, e11, e22, e12 = _WindowFilter.apply(stack, kernel).split(c, 1)
    mu1_sq = mu1 ** 2
    mu2_sq = mu2 ** 2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    C1 = 0.01 ** 2
    C2 = 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
