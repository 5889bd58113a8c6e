"""Relevancy-map post-processing and metrics
(port of langsplatv2_tpu/eval/processing.py; reference eval_lerf.py:104-200).

- 29x29 average pool, stride 1, count_include_pad=False, blended
  0.5 (avg + raw);
- min-max normalization into [-1, 1], clipped to [0, 1];
- threshold -> binary mask -> 7x7 average-pool majority smoothing;
- per-level IoU against the GT masks, the level chosen by the largest
  smoothed relevancy;
- localization: the smoothed arg-max set inside any GT box.

Plain torch on the map's device. Every function takes a stack of maps
[..., H, W] and pools them in one call; the per-prompt choices (levels,
arg-max coordinates) are taken on the host.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def avg_pool_same(x: torch.Tensor, kernel: int, padding: int) -> torch.Tensor:
    """[..., H, W] average pool, stride 1, count_include_pad=False (border
    windows divide by their in-bounds count)."""
    h, w = x.shape[-2:]
    out = F.avg_pool2d(x.reshape(-1, 1, h, w).float(), kernel, stride=1,
                       padding=padding, count_include_pad=False)
    return out.reshape(x.shape)


def smooth_mask(mask: torch.Tensor) -> torch.Tensor:
    """7x7 majority smoothing (reference smooth_cuda, eval_lerf.py:104-109)."""
    return (avg_pool_same(mask.float(), 7, 3) > 0.5).to(torch.uint8)


def heatmap_to_mask(valid: torch.Tensor, thresh: float):
    """Heatmaps [..., H, W] -> (smoothed heatmaps, binary masks), each map
    normalized by its own min and max (eval_lerf.py:121-137)."""
    avg = avg_pool_same(valid, 29, 14)
    blended = 0.5 * (avg + valid)
    lo = blended.amin(dim=(-2, -1), keepdim=True)
    hi = blended.amax(dim=(-2, -1), keepdim=True)
    out = (blended - lo) / (hi - lo + 1e-9)
    out = torch.clamp(out * 2.0 - 1.0, 0.0, 1.0)
    return blended, smooth_mask((out > thresh).to(torch.uint8))


def iou(mask_a: torch.Tensor, mask_b: torch.Tensor) -> torch.Tensor:
    """IoU of binary masks over their last two dims (f32)."""
    a, b = mask_a.bool(), mask_b.bool()
    inter = (a & b).sum(dim=(-2, -1)).float()
    union = (a | b).sum(dim=(-2, -1)).float()
    return inter / union


def _gt_stack(gt: dict, prompts: list[str], device) -> torch.Tensor:
    return torch.stack([torch.as_tensor(np.asarray(gt[p]).astype(np.uint8),
                                        device=device) for p in prompts])


def segmentation_process(valid_map: torch.Tensor, thresh: float,
                         gt_masks: dict, prompts: list[str]):
    """valid_map [levels, prompts, H, W] -> per prompt the IoU at the level
    whose smoothed relevancy peaks highest (eval_lerf.py:111-156). Returns
    (chosen_iou_list, chosen_lvl_list, {prompt: [IoU per level]})."""
    valid_map = torch.as_tensor(valid_map)
    blended, mask_pred = heatmap_to_mask(valid_map, thresh)
    gt = _gt_stack(gt_masks, prompts, valid_map.device)      # [P, H, W]
    ious = iou(gt[None], mask_pred).cpu().numpy()            # [L, P]
    scores = blended.amax(dim=(-2, -1)).cpu().numpy()
    chosen = np.argmax(scores, axis=0)
    iou_all = {p: [float(v) for v in ious[:, k]]
               for k, p in enumerate(prompts)}
    return ([float(ious[c, k]) for k, c in enumerate(chosen)],
            [int(c) for c in chosen], iou_all)


def localization_process(valid_map, gt_bboxes: dict,
                         prompts: list[str]) -> int:
    """The number of prompts whose smoothed-relevancy arg-max set, at the
    level that peaks highest, has a point inside any GT box (x1 y1 x2 y2;
    eval_lerf.py:158-200)."""
    avg = avg_pool_same(torch.as_tensor(valid_map), 29, 14)   # [L, P, H, W]
    scores = avg.amax(dim=(-2, -1))
    head = torch.argmax(scores.cpu(), dim=0)   # first of equal maxima
    acc_num = 0
    for k, p in enumerate(prompts):
        i = int(head[k])
        yx = torch.nonzero(avg[i, k] == scores[i, k]).cpu().numpy()
        boxes = np.asarray(gt_bboxes[p]).reshape(-1, 4)
        x_min = np.minimum(boxes[:, 0], boxes[:, 2])[:, None]
        x_max = np.maximum(boxes[:, 0], boxes[:, 2])[:, None]
        y_min = np.minimum(boxes[:, 1], boxes[:, 3])[:, None]
        y_max = np.maximum(boxes[:, 1], boxes[:, 3])[:, None]
        y, x = yx[:, 0][None], yx[:, 1][None]
        acc_num += int(((x_min <= x) & (x <= x_max) & (y_min <= y)
                        & (y <= y_max)).any())
    return acc_num


def polygon_to_mask(shape: tuple[int, int], points) -> np.ndarray:
    """Rasterize a labelme polygon to a bool mask (reference
    eval/utils.py:97-103); needs cv2."""
    import cv2

    mask = np.zeros(shape, dtype=np.uint8)
    pts = np.asarray(points, np.int32).reshape(-1, 2)
    cv2.fillPoly(mask, [pts], 1)
    return mask.astype(bool)


def stack_mask(mask_base: np.ndarray, mask_add: np.ndarray) -> np.ndarray:
    """Union of GT masks for a repeated label (reference eval/utils.py:104)."""
    return np.logical_or(mask_base, mask_add)


def mode_smooth(mask: np.ndarray) -> np.ndarray:
    """5x5 mode filter (reference eval/utils.py:61-70 `smooth`); needs
    scipy."""
    from scipy.ndimage import generic_filter

    def mode_fn(vals):
        return np.bincount(vals.astype(np.int64)).argmax()

    return generic_filter(mask.astype(np.int64), mode_fn,
                          size=5).astype(mask.dtype)
