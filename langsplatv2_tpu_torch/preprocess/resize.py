"""Bilinear resizes that give OpenCV's `cv2.resize(..., INTER_LINEAR)`
results, in torch on the tensor's device (the JAX preprocess calls cv2:
the 224x224 crop tiles, SAM's input resize, the logit upscale, the
image-height cap; the card's machine has no cv2).

uint8 images (`resize_linear_u8`), bit for bit:
- an exact 2x downscale of both sides is cv2's INTER_AREA fast path,
  (a + b + c + d + 2) >> 2;
- otherwise the source coordinate of output index d is
  float32((d + 0.5) * scale - 0.5) with scale = 1 / (dst / src) in
  double; its floor is the first tap and the rest the fraction f; the
  taps' weights are round-half-even(2048 (1 - f)) and round(2048 f)
  (11-bit fixed point). Columns left of 0 or right of the last take the
  edge pixel with weight 2048; rows are clamped to the image and keep
  their weights;
- the horizontal pass sums integer products exactly; the vertical pass
  is cv2's vector form: ((r0 >> 4) * w0 >> 16) + ((r1 >> 4) * w1 >> 16),
  then (x + 2) >> 2, saturated to 0..255.

float32 maps (`resize_linear_f32`): a horizontal then a vertical pass,
each out = fma(f, b - a, a) with f = float32 of the double fraction of
(d + 0.5) * (src / dst) - 0.5 (an exact 2x downscale included); an image
one pixel wide or tall takes cv2's other path, a0 a + a1 b with
float32 coordinates. The fused multiply-add is formed in float64, so a
result may differ from cv2's where the double sum rounds onto a float32
midpoint (not seen in the tests).
"""
from __future__ import annotations

import numpy as np
import torch

_COEF_ONE = 2048             # cv2's INTER_RESIZE_COEF_SCALE, 11 bits


def _float_coords(src: int, dst: int):
    """cv2's coordinates along one axis in float32: (first tap, fraction),
    unclamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(np.float32)).astype(np.float32)
    return s, f


def _weights(f: np.ndarray):
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_ONE))
    w1 = np.rint(f * np.float32(_COEF_ONE))
    return w0.astype(np.int32), w1.astype(np.int32)


def _column_taps(src: int, dst: int):
    s, f = _float_coords(src, dst)
    low = s < 0
    f = np.where(low, np.float32(0), f)
    s = np.where(low, 0, s)
    high = s >= src - 1
    f = np.where(high, np.float32(0), f)
    s = np.where(high, src - 1, s)
    return s, np.minimum(s + 1, src - 1), f


def resize_linear_u8(image: torch.Tensor, width: int,
                     height: int) -> torch.Tensor:
    """uint8 [H, W, C] -> [height, width, C], equal to
    cv2.resize(image, (width, height)) at INTER_LINEAR."""
    image = torch.as_tensor(image)
    if image.dtype != torch.uint8 or image.dim() != 3:
        raise ValueError("resize_linear_u8 takes a uint8 [H, W, C] image")
    src_h, src_w = image.shape[:2]
    dev = image.device
    if src_h == 2 * height and src_w == 2 * width:
        s = image.to(torch.int32)
        out = (s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2]
               + s[1::2, 1::2] + 2) >> 2
        return out.to(torch.uint8)
    x0, x1, fx = _column_taps(src_w, width)
    a0, a1 = _weights(fx)
    s = image.to(torch.int32)
    idx0 = torch.as_tensor(x0, device=dev)
    idx1 = torch.as_tensor(x1, device=dev)
    rows = (s[:, idx0] * torch.as_tensor(a0, device=dev)[:, None]
            + s[:, idx1] * torch.as_tensor(a1, device=dev)[:, None])
    sy, fy = _float_coords(src_h, height)
    b0, b1 = _weights(fy)
    y0 = torch.as_tensor(np.clip(sy, 0, src_h - 1), device=dev)
    y1 = torch.as_tensor(np.clip(sy + 1, 0, src_h - 1), device=dev)
    b0 = torch.as_tensor(b0, device=dev)[:, None, None]
    b1 = torch.as_tensor(b1, device=dev)[:, None, None]
    out = (((rows[y0] >> 4) * b0) >> 16) + (((rows[y1] >> 4) * b1) >> 16)
    return torch.clamp((out + 2) >> 2, 0, 255).to(torch.uint8)


def _lerp_taps(src: int, dst: int):
    pos = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(pos).astype(np.int64)
    frac = pos - s
    low = s < 0
    frac = np.where(low, 0.0, frac)
    s = np.where(low, 0, s)
    high = s >= src - 1
    frac = np.where(high, 0.0, frac)
    s = np.where(high, src - 1, s)
    return s, np.minimum(s + 1, src - 1), frac.astype(np.float32)


def _fma_lerp(a: torch.Tensor, b: torch.Tensor,
              f: torch.Tensor) -> torch.Tensor:
    """float32 fma(f, b - a, a), the difference rounded to float32."""
    return (a.double() + f.double() * (b - a).double()).float()


def _generic_f32(x: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """cv2's path for a source one pixel wide or tall."""
    src_h, src_w = x.shape[-2:]
    dev = x.device
    sx, fx = _float_coords(src_w, width)
    low = sx < 0
    fx = np.where(low, np.float32(0), fx)
    sx = np.where(low, 0, sx)
    high = sx >= src_w - 1
    fx = np.where(high, np.float32(0), fx)
    sx = np.where(high, src_w - 1, sx)
    a1 = torch.as_tensor(fx, device=dev)
    a0 = torch.as_tensor(np.float32(1) - fx, device=dev)
    rows = (x[..., torch.as_tensor(sx, device=dev)] * a0
            + x[..., torch.as_tensor(np.minimum(sx + 1, src_w - 1),
                                     device=dev)] * a1)
    sy, fy = _float_coords(src_h, height)
    b1 = torch.as_tensor(fy, device=dev)[:, None]
    b0 = torch.as_tensor(np.float32(1) - fy, device=dev)[:, None]
    y0 = torch.as_tensor(np.clip(sy, 0, src_h - 1), device=dev)
    y1 = torch.as_tensor(np.clip(sy + 1, 0, src_h - 1), device=dev)
    return rows[..., y0, :] * b0 + rows[..., y1, :] * b1


def resize_linear_f32(x: torch.Tensor, width: int,
                      height: int) -> torch.Tensor:
    """float32 [..., H, W] -> [..., height, width], each map as
    cv2.resize(map, (width, height)) at INTER_LINEAR."""
    x = torch.as_tensor(x)
    if x.dtype != torch.float32:
        raise ValueError("resize_linear_f32 takes float32 maps")
    src_h, src_w = x.shape[-2:]
    if src_h == 1 or src_w == 1:
        return _generic_f32(x, width, height)
    dev = x.device
    x0, x1, fx = _lerp_taps(src_w, width)
    rows = _fma_lerp(x[..., torch.as_tensor(x0, device=dev)],
                     x[..., torch.as_tensor(x1, device=dev)],
                     torch.as_tensor(fx, device=dev))
    y0, y1, fy = _lerp_taps(src_h, height)
    return _fma_lerp(rows[..., torch.as_tensor(y0, device=dev), :],
                     rows[..., torch.as_tensor(y1, device=dev), :],
                     torch.as_tensor(fy, device=dev)[:, None])
