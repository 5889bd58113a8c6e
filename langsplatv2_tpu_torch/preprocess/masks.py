"""SAM mask post-processing: NMS, crops, segmentation maps
(port of langsplatv2_tpu/preprocess/masks.py; reference
preprocess.py:191-330).

The intersection counts of every mask pair are one product of the
flattened masks on the device (f32 with TF32 off: 0/1 operands, integer
sums below 2**24, so the counts are exact); the NMS rules that read them
run on the host in numpy exactly as JAX's do (the stable argsorts, the
asymmetric 0.5 / 0.85 gates, the top-3 fallbacks, `np.tril(..., k=1)`).
The crops, their square pads, the 224x224 tiles (`resize.resize_linear_u8`,
cv2's INTER_LINEAR bit for bit) and the seg map are built on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import no_tf32_matmul, resolve_device
from .resize import resize_linear_u8

TILE = 224


def intersection_counts(masks, device=None) -> torch.Tensor:
    """masks [M, H, W] bool -> [M, M] f32 intersection counts on the
    device, one matrix product."""
    dev = resolve_device(device)
    m = len(masks)
    flat = torch.as_tensor(np.asarray(masks) if not torch.is_tensor(masks)
                           else masks, device=dev).reshape(m, -1).float()
    with no_tf32_matmul():
        return flat @ flat.T


def mask_iou_matrices(masks, device=None):
    """masks [M, H, W] bool -> (iou [M, M], inter [M, M], areas [M]),
    numpy f32 as JAX returns them."""
    inter = intersection_counts(masks, device).cpu().numpy()
    areas = np.diagonal(inter).copy()
    union = areas[:, None] + areas[None, :] - inter
    iou = inter / np.maximum(union, np.float32(1.0))
    return iou, inter, areas


def mask_nms(masks, scores: np.ndarray, iou_thr: float = 0.7,
             score_thr: float = 0.1, inner_thr: float = 0.2,
             device=None) -> np.ndarray:
    """Mask NMS with inner-overlap suppression (reference
    preprocess.py:215-279). masks [M, H, W] bool; scores [M]. Returns the
    selected original indices."""
    order = np.argsort(-scores, kind="stable")
    scores_ord = scores[order]
    masks_ord = masks[order] if not torch.is_tensor(masks) else \
        masks[torch.as_tensor(order, device=masks.device)]

    iou, inter, areas = mask_iou_matrices(masks_ord, device)
    M = len(scores)

    ratio_i = inter / np.maximum(areas[:, None], 1.0)   # inter/area_i
    ratio_j = inter / np.maximum(areas[None, :], 1.0)   # inter/area_j
    inner = 1.0 - ratio_j * ratio_i
    # Pair (i, j), i<j in score order: j mostly inside i (asymmetric gates).
    upper_cond = (ratio_i < 0.5) & (ratio_j >= 0.85)
    lower_cond = (ratio_i >= 0.85) & (ratio_j < 0.5)

    inner_u = np.where(upper_cond, inner, 0.0)
    inner_l = np.where(lower_cond, inner, 0.0).T

    iu = np.triu(iou, k=1)
    iou_max = iu.max(axis=0) if M else np.zeros(0)
    inner_u = np.triu(inner_u, k=1)
    inner_max_u = inner_u.max(axis=0) if M else np.zeros(0)
    inner_l = np.tril(inner_l, k=1)
    inner_max_l = inner_l.max(axis=0) if M else np.zeros(0)

    keep = iou_max <= iou_thr
    keep_conf = scores_ord > score_thr
    keep_inner_u = inner_max_u <= 1 - inner_thr
    keep_inner_l = inner_max_l <= 1 - inner_thr

    top3 = np.argsort(-scores_ord, kind="stable")[:3]
    if keep_conf.sum() == 0:
        keep_conf[top3] = True
    if keep_inner_u.sum() == 0:
        keep_inner_u[top3] = True
    if keep_inner_l.sum() == 0:
        keep_inner_l[top3] = True

    keep = keep & keep_conf & keep_inner_u & keep_inner_l
    return order[keep]


def masks_update(*mask_levels, iou_thr=0.8, score_thr=0.7, inner_thr=0.5,
                 device=None):
    """Filter each level's SAM mask list (reference preprocess.py:281-294).
    Each mask is a dict with 'segmentation', 'predicted_iou',
    'stability_score'; a level's masks go to the device once."""
    dev = resolve_device(device)
    out = []
    for masks_lvl in mask_levels:
        if not masks_lvl:
            out.append(masks_lvl)
            continue
        seg = torch.stack([torch.as_tensor(m["segmentation"], device=dev)
                           for m in masks_lvl])
        iou_pred = np.asarray([m["predicted_iou"] for m in masks_lvl])
        stability = np.asarray([m["stability_score"] for m in masks_lvl])
        scores = stability * iou_pred
        keep = set(mask_nms(seg, scores, iou_thr, score_thr, inner_thr,
                            device=dev).tolist())
        out.append([m for i, m in enumerate(masks_lvl) if i in keep])
    return tuple(out)


def get_seg_img(mask: dict, image: torch.Tensor) -> torch.Tensor:
    """Black out the background, crop the bbox (reference
    preprocess.py:191). image [H, W, 3] uint8 on its device."""
    seg = torch.as_tensor(mask["segmentation"], device=image.device)
    x, y, w, h = np.int32(mask["bbox"])
    out = torch.where(seg[..., None], image, torch.zeros_like(image))
    return out[y:y + h, x:x + w]


def pad_img(img: torch.Tensor) -> torch.Tensor:
    """Center-pad to square (reference preprocess.py:198-206)."""
    h, w, _ = img.shape
    side = max(w, h)
    pad = torch.zeros((side, side, 3), dtype=torch.uint8, device=img.device)
    if h > w:
        pad[:, (h - w) // 2:(h - w) // 2 + w, :] = img
    else:
        pad[(w - h) // 2:(w - h) // 2 + h, :, :] = img
    return pad


def mask_to_segmap(masks: list[dict], image, device=None):
    """Masks -> (tiles [M, 3, 224, 224] f32 in [0, 1], seg_map [H, W]
    int32, -1 where no mask lies; later masks overwrite earlier ones —
    reference mask2segmap, preprocess.py:304-317), both on the device."""
    dev = resolve_device(device)
    image = torch.tensor(np.asarray(image), device=dev)
    tiles = []
    seg_map = torch.full(image.shape[:2], -1, dtype=torch.int32, device=dev)
    for i, mask in enumerate(masks):
        tiles.append(resize_linear_u8(pad_img(get_seg_img(mask, image)),
                                      TILE, TILE))
        seg = torch.as_tensor(mask["segmentation"], device=dev)
        seg_map = torch.where(seg, i, seg_map)
    tiles = torch.stack(tiles).permute(0, 3, 1, 2).float() / 255.0
    return tiles.contiguous(), seg_map
