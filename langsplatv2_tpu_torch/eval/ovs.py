"""3D-OVS benchmark driver (port of langsplatv2_tpu/eval/ovs.py; reference
eval_3d_ovs.py): per-frame mask-folder GT (255 -> 1 pngs, 'wood wall'
ordered last), mIoU over the prompts at mask_thresh 0.25, and the 'room'
case, which skips the last two prompts and picks the level by the mean
relevancy inside the predicted mask (level 0 excluded).
"""
from __future__ import annotations

import os
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from . import processing
from .lerf import _vis_mask_save, quick_relevancy, \
    render_language_feature_map_full
from .openclip import OpenCLIPNetwork


def eval_gt_ovsdata(mask_dir: str, output_path: str | None = None):
    """Reference eval_3d_ovs.py:58-100 (needs cv2). Returns (gt_ann,
    frame_ids)."""
    import cv2

    gt_ann = {}
    frame_ids = []
    for frame_id in sorted(os.listdir(mask_dir)):
        if "txt" in frame_id:
            continue
        frame_dir = os.path.join(mask_dir, frame_id)
        if not os.path.isdir(frame_dir):
            continue
        names = [n for n in os.listdir(frame_dir) if n != "wood wall.png"]
        if "wood wall.png" in os.listdir(frame_dir):
            names.append("wood wall.png")  # always ordered last
        img_ann = defaultdict(dict)
        for name in names:
            prompt = os.path.splitext(name)[0]
            mask = cv2.imread(os.path.join(frame_dir, name))
            mask[mask == 255] = 1
            img_ann[prompt]["mask"] = mask[:, :, 0]
            if output_path is not None:
                save = Path(output_path) / "gt" / frame_id / f"{prompt}.jpg"
                save.parent.mkdir(exist_ok=True, parents=True)
                _vis_mask_save(mask[:, :, 0], str(save))
        gt_ann[frame_id] = img_ann
        frame_ids.append(frame_id)
    return gt_ann, frame_ids


def segmentation_process_room(valid_map, thresh: float, gt_masks: dict,
                              prompts: list[str]):
    """The room variant (eval_3d_ovs.py:109-213): the last 2 prompts
    skipped; the level chosen by the mean relevancy inside the predicted
    mask, levels 1 and up only. GT masks of another size are resized
    (nearest, cv2)."""
    valid_map = torch.as_tensor(valid_map)
    n_head, n_prompt, h, w = valid_map.shape
    kept = list(prompts[:n_prompt - 2])
    if not kept:
        return [], []
    gts = []
    for p in kept:
        gt = np.asarray(gt_masks[p])
        if gt.shape != (h, w):
            import cv2

            gt = cv2.resize(gt, (w, h), interpolation=cv2.INTER_NEAREST)
        gts.append(gt)
    blended, mask_pred = processing.heatmap_to_mask(
        valid_map[:, :len(kept)], thresh)
    gt = torch.as_tensor(np.stack(gts).astype(np.uint8),
                         device=valid_map.device)
    ious = processing.iou(gt[None], mask_pred).cpu().numpy()     # [L, P]
    mask_f = mask_pred.float()
    denom = mask_f.sum(dim=(-2, -1))
    num = (blended * mask_f).sum(dim=(-2, -1))
    scores = torch.where(denom > 0, num / torch.clamp(denom, min=1.0),
                         0.0).cpu().numpy()
    scores[0] = 0.0   # level 0 excluded from the choice (loop starts at 1)
    chosen = np.argmax(scores, axis=0)
    return ([float(ious[c, k]) for k, c in enumerate(chosen)],
            [int(c) for c in chosen])


def _segment(valid_map, img_ann, prompts, mask_thresh, scene_name):
    masks = {p: img_ann[p]["mask"] for p in prompts}
    if scene_name == "room":
        return segmentation_process_room(valid_map, mask_thresh, masks,
                                         prompts)
    c_iou, c_lvl, _ = processing.segmentation_process(
        valid_map, mask_thresh, masks, prompts)
    return c_iou, c_lvl


def evaluate(models, cameras_by_frame: dict, gt_ann: dict,
             clip_model: OpenCLIPNetwork | None = None,
             mask_thresh: float = 0.25, scene_name: str = "", logger=None,
             *, device=None):
    """Non-quick 3D-OVS evaluation (reference `evaluate`,
    eval_3d_ovs.py:289-341): the per-level models, full per-level decode."""
    dev = resolve_device(device)
    clip_model = clip_model or OpenCLIPNetwork(device=dev)
    bg = torch.zeros(3, device=dev)
    chosen_iou_all = []
    for frame_id, img_ann in gt_ann.items():
        prompts = list(img_ann.keys())
        clip_model.set_positives(prompts)
        feats = render_language_feature_map_full(
            models, cameras_by_frame[frame_id], bg, device=dev)
        valid_map = clip_model.get_max_across_quick(feats.permute(0, 2, 3, 1))
        c_iou, c_lvl = _segment(valid_map, img_ann, prompts, mask_thresh,
                                scene_name)
        chosen_iou_all.extend(c_iou)
        if logger:
            logger.info(f"frame {frame_id}: iou {c_iou} lvl {c_lvl}")
    return {
        "mean_iou": float(np.mean(chosen_iou_all)) if chosen_iou_all else 0.0,
        "num_prompts": len(chosen_iou_all),
    }


def evaluate_quick(merged_model, cameras_by_frame: dict, gt_ann: dict,
                   clip_model: OpenCLIPNetwork | None = None,
                   mask_thresh: float = 0.25, scene_name: str = "",
                   logger=None, gram_relevancy: bool = True, *, device=None):
    """3D-OVS quick evaluation (reference evaluate_quick,
    eval_3d_ovs.py:289-435); `cameras_by_frame[frame_id]` is the camera."""
    dev = resolve_device(device)
    clip_model = clip_model or OpenCLIPNetwork(device=dev)
    chosen_iou_all = []
    for frame_id, img_ann in gt_ann.items():
        prompts = list(img_ann.keys())
        clip_model.set_positives(prompts)
        valid_map, _ = quick_relevancy(merged_model,
                                       cameras_by_frame[frame_id], clip_model,
                                       gram_relevancy, device=dev)
        c_iou, c_lvl = _segment(valid_map, img_ann, prompts, mask_thresh,
                                scene_name)
        chosen_iou_all.extend(c_iou)
        if logger:
            logger.info(f"frame {frame_id}: iou {c_iou} lvl {c_lvl}")
    return {
        "mean_iou": float(np.mean(chosen_iou_all)) if chosen_iou_all else 0.0,
        "num_prompts": len(chosen_iou_all),
    }
