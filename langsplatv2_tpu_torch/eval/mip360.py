"""Mip-NeRF360 open-vocabulary benchmark driver (port of
langsplatv2_tpu/eval/mip360.py; reference eval_mip_nerf360.py): labelme
GT as for LERF, rendered feature maps resized to the GT resolution before
relevancy (eval_mip_nerf360.py:195, 223, 300-302), and the level chosen by
the mean relevancy inside the GT mask (144-149). mask_thresh 0.4.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.renderer import make_settings
from . import processing
from .lerf import _pose, render_language_feature_map_full, \
    render_language_feature_map_quick
from .openclip import OpenCLIPNetwork


def resize_feature_map(feats: torch.Tensor, height: int,
                       width: int) -> torch.Tensor:
    """Bilinear resize [L, C, H, W] -> [L, C, height, width], half-pixel
    centres, antialiased when it shrinks an axis (the triangle filter
    widened by the scale), as jax.image.resize(..., "bilinear") does."""
    return F.interpolate(feats, size=(height, width), mode="bilinear",
                         align_corners=False, antialias=True)


def segmentation_process_mask_score(valid_map, thresh: float,
                                    gt_masks: dict, prompts: list[str]):
    """The level chosen by the mean relevancy inside the GT mask
    (eval_mip_nerf360.py:144-149); the IoU machinery is LERF's."""
    valid_map = torch.as_tensor(valid_map)
    blended, mask_pred = processing.heatmap_to_mask(valid_map, thresh)
    gt = torch.stack([torch.as_tensor(np.asarray(gt_masks[p]).astype(np.uint8),
                                      device=valid_map.device)
                      for p in prompts])                          # [P, H, W]
    ious = processing.iou(gt[None], mask_pred).cpu().numpy()      # [L, P]
    gt_f = gt.float()
    scores = ((blended * gt_f).sum(dim=(-2, -1))
              / torch.clamp(gt_f.sum(dim=(-2, -1)), min=1.0)).cpu().numpy()
    chosen = np.argmax(scores, axis=0)
    return ([float(ious[c, k]) for k, c in enumerate(chosen)],
            [int(c) for c in chosen])


def _score(feats, img_ann, gt_h, gt_w, clip_model, mask_thresh):
    if feats.shape[-2:] != (gt_h, gt_w):
        feats = resize_feature_map(feats, gt_h, gt_w)
    prompts = list(img_ann.keys())
    clip_model.set_positives(prompts)
    valid_map = clip_model.get_max_across_quick(feats.permute(0, 2, 3, 1))
    masks = {p: img_ann[p]["mask"] for p in prompts}
    bboxes = {p: img_ann[p]["bboxes"] for p in prompts}
    c_iou, c_lvl = segmentation_process_mask_score(valid_map, mask_thresh,
                                                   masks, prompts)
    acc = processing.localization_process(valid_map, bboxes, prompts)
    return c_iou, c_lvl, acc, len(prompts)


def _evaluate(feats_of, cameras, gt_ann, image_shape, clip_model,
              mask_thresh, logger, dev):
    clip_model = clip_model or OpenCLIPNetwork(device=dev)
    gt_h, gt_w = image_shape
    chosen_iou_all = []
    acc_num = total = 0
    for j_str, img_ann in gt_ann.items():
        c_iou, c_lvl, acc, n = _score(feats_of(cameras[int(j_str)]), img_ann,
                                      gt_h, gt_w, clip_model, mask_thresh)
        chosen_iou_all.extend(c_iou)
        acc_num += acc
        total += n
        if logger:
            logger.info(f"frame {j_str}: iou {c_iou} lvl {c_lvl}")
    return {
        "mean_iou": float(np.mean(chosen_iou_all)) if chosen_iou_all else 0.0,
        "localization_accuracy": acc_num / max(total, 1),
        "num_prompts": total,
    }


def evaluate(models, cameras, gt_ann, image_shape,
             clip_model: OpenCLIPNetwork | None = None,
             mask_thresh: float = 0.4, logger=None, *, device=None):
    """Non-quick Mip-NeRF360 evaluation: the per-level models with the full
    per-level decode (the reference `evaluate` formulation)."""
    dev = resolve_device(device)
    bg = torch.zeros(3, device=dev)
    return _evaluate(
        lambda cam: render_language_feature_map_full(models, cam, bg,
                                                     device=dev),
        cameras, gt_ann, image_shape, clip_model, mask_thresh, logger, dev)


def evaluate_quick(merged_model, cameras, gt_ann, image_shape,
                   clip_model: OpenCLIPNetwork | None = None,
                   mask_thresh: float = 0.4, logger=None, *, device=None):
    """Quick Mip-NeRF360 evaluation: the merged model's decoded map,
    resized to the GT resolution."""
    dev = resolve_device(device)
    bg = torch.zeros(3, device=dev)

    def feats_of(cam):
        settings = make_settings(cam, merged_model.active_sh_degree)
        return render_language_feature_map_quick(
            merged_model, settings, *_pose(cam), bg, device=dev)

    return _evaluate(feats_of, cameras, gt_ann, image_shape, clip_model,
                     mask_thresh, logger, dev)
