"""LERF open-vocabulary benchmark driver
(port of langsplatv2_tpu/eval/lerf.py; reference eval_lerf.py): labelme
GT parsing, the merged 3-level quick-render path, mean chosen IoU and
localization accuracy.

`evaluate_quick(gram_relevancy=True)` renders the merged model's 192
channels as tiles (assemble=False: K1, K2) and takes relevancy from them
through the Gram query (K3, `relevancy_from_tiles`), the port's serving
path; JAX computes the same numbers with einsums on the assembled map.
As in JAX, every frame is rendered with `make_settings(cam, sh)`, whose
entry budget is 2**21: a frame whose expansion overflows it is scored
truncated (`RenderOutput.total_entries` reports the overflow; callers that
care check it). Entry points take `device=` (CUDA unless "cpu").
"""
from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..models.gaussians import GaussianModel
from ..models.renderer import make_settings, render
from ..ops.rasterize import mark_stage
from . import processing
from .openclip import OpenCLIPNetwork


def eval_gt_lerfdata(json_folder: str, output_path: str | None = None):
    """Parse labelme GT (reference eval_lerf.py:61-102). Returns
    (gt_ann, (h, w), img_paths); needs cv2 for the polygons."""
    gt_json_paths = sorted(glob.glob(os.path.join(json_folder,
                                                  "frame_*.json")))
    img_paths = sorted(glob.glob(os.path.join(json_folder, "frame_*.jpg")))
    gt_ann = {}
    h = w = 0
    for js_path in gt_json_paths:
        img_ann = defaultdict(dict)
        with open(js_path) as f:
            gt_data = json.load(f)
        h, w = gt_data["info"]["height"], gt_data["info"]["width"]
        idx = int(gt_data["info"]["name"].split("_")[-1].split(".jpg")[0]) - 1
        for prompt_data in gt_data["objects"]:
            label = prompt_data["category"]
            box = np.asarray(prompt_data["bbox"]).reshape(-1)
            mask = processing.polygon_to_mask((h, w),
                                              prompt_data["segmentation"])
            if img_ann[label].get("mask", None) is not None:
                mask = processing.stack_mask(img_ann[label]["mask"], mask)
                img_ann[label]["bboxes"] = np.concatenate(
                    [img_ann[label]["bboxes"].reshape(-1, 4),
                     box.reshape(-1, 4)], axis=0)
            else:
                img_ann[label]["bboxes"] = box
            img_ann[label]["mask"] = mask
            if output_path is not None:
                save_path = Path(output_path) / "gt" / \
                    gt_data["info"]["name"].split(".jpg")[0] / f"{label}.jpg"
                save_path.parent.mkdir(exist_ok=True, parents=True)
                _vis_mask_save(mask, str(save_path))
        gt_ann[f"{idx}"] = img_ann
    return gt_ann, (h, w), img_paths


def _vis_mask_save(mask: np.ndarray, path: str):
    import cv2

    cv2.imwrite(path, (np.asarray(mask).astype(np.uint8) * 255))


def merge_level_models(models: list[GaussianModel],
                       topk: int = 4) -> GaussianModel:
    """Per-level models -> one quick-render model: weights/indices
    [N, levels*topk] with indices offset by level * (codebook rows of a
    model), codebooks stacked [levels, K, 512]."""
    ws, idxs, books = [], [], []
    for lvl, m in enumerate(models):
        w, idx = m.get_weights_and_indices(topk)
        ws.append(w)
        idxs.append(idx + lvl * m.codebooks.shape[1] * m.codebooks.shape[0])
        books.append(m.codebooks.detach())
    return models[0].replace(quick_weights=torch.cat(ws, dim=1),
                             quick_indices=torch.cat(idxs, dim=1),
                             codebooks=torch.cat(books, dim=0))


def _pose(cam):
    return (np.asarray(cam.world_view_transform, np.float32),
            np.asarray(cam.full_proj_transform, np.float32),
            np.asarray(cam.camera_center, np.float32))


def render_language_feature_map_quick(model: GaussianModel, settings, view,
                                      proj, campos, bg, *, device=None
                                      ) -> torch.Tensor:
    """One 192-channel quick render, decoded per level and L2-normalized
    (reference eval_lerf.py:210-220). Returns [levels, 512, H, W]."""
    with torch.no_grad():
        out = render(settings, model, view, proj, campos, bg,
                     quick_render=True, device=device)
        wmap = out.language_feature_weight_map
        L, K, D = model.codebooks.shape
        _, H, W = wmap.shape
        feats = torch.einsum("lkd,lkn->ldn", model.codebooks,
                             wmap.reshape(L, K, H * W))
        feats = feats / (torch.linalg.norm(feats, dim=1, keepdim=True)
                         + 1e-10)
    return feats.reshape(L, D, H, W)


def render_language_feature_map_full(models: list[GaussianModel], cam, bg,
                                     *, device=None) -> torch.Tensor:
    """The non-quick form (reference `evaluate`, eval_lerf.py:223-291):
    each per-level model renders its own top-4 weight map, decoded and
    L2-normalized. Returns [levels, 512, H, W]."""
    view, proj, campos = _pose(cam)
    feats = []
    with torch.no_grad():
        for m in models:
            settings = make_settings(cam, m.active_sh_degree)
            out = render(settings, m, view, proj, campos, bg,
                         include_feature=True, topk=4, device=device)
            feat = m.compute_layer_feature_map(
                out.language_feature_weight_map, m.codebooks.shape[0] - 1)
            feats.append(feat / (torch.linalg.norm(feat, dim=0, keepdim=True)
                                 + 1e-10))
    return torch.stack(feats, dim=0)


def _score_frame(valid_map, img_ann: dict, prompts, mask_thresh: float,
                 stage_events):
    masks = {p: img_ann[p]["mask"] for p in prompts}
    bboxes = {p: img_ann[p]["bboxes"] for p in prompts}
    c_iou, c_lvl, _ = processing.segmentation_process(
        valid_map, mask_thresh, masks, prompts)
    mark_stage(stage_events, "segmentation")
    acc = processing.localization_process(valid_map, bboxes, prompts)
    mark_stage(stage_events, "localization")
    return c_iou, c_lvl, acc


def _summary(chosen_iou_all, chosen_lvl_list, acc_num, total_prompts):
    return {
        "mean_iou": float(np.mean(chosen_iou_all)) if chosen_iou_all else 0.0,
        "localization_accuracy": acc_num / max(total_prompts, 1),
        "chosen_levels": chosen_lvl_list,
        "num_prompts": total_prompts,
    }


def evaluate(models: list[GaussianModel], cameras: list, gt_ann: dict,
             image_shape: tuple[int, int],
             clip_model: OpenCLIPNetwork | None = None,
             mask_thresh: float = 0.4, logger=None, *, device=None):
    """Non-quick benchmark (reference `evaluate`, eval_lerf.py:223-291):
    the per-level models with the full per-level decode. Same metrics as
    evaluate_quick; their agreement validates the merge."""
    dev = resolve_device(device)
    clip_model = clip_model or OpenCLIPNetwork(device=dev)
    chosen_iou_all, chosen_lvl_list = [], []
    acc_num = total_prompts = 0
    bg = torch.zeros(3, device=dev)
    for j_str, img_ann in gt_ann.items():
        cam = cameras[int(j_str)]
        prompts = list(img_ann.keys())
        clip_model.set_positives(prompts)
        feats = render_language_feature_map_full(models, cam, bg, device=dev)
        valid_map = clip_model.get_max_across_quick(feats.permute(0, 2, 3, 1))
        c_iou, c_lvl, acc = _score_frame(valid_map, img_ann, prompts,
                                         mask_thresh, None)
        chosen_iou_all.extend(c_iou)
        chosen_lvl_list.extend(c_lvl)
        acc_num += acc
        total_prompts += len(prompts)
        if logger:
            logger.info(f"frame {j_str}: iou {c_iou} lvl {c_lvl} "
                        f"acc {acc}/{len(prompts)}")
    return _summary(chosen_iou_all, chosen_lvl_list, acc_num, total_prompts)


def quick_relevancy(merged_model: GaussianModel, cam, clip_model,
                    gram_relevancy: bool = True, *, device=None,
                    stage_events: list | None = None):
    """One frame's relevancy [L, positives, H, W] for the prompts already
    set on clip_model, and its RenderOutput (None on the decode route).
    gram_relevancy: tiles -> K3 query -> relevancy; else the decoded
    [L, H, W, 512] map through get_max_across_quick."""
    dev = resolve_device(device)
    settings = make_settings(cam, merged_model.active_sh_degree)
    view, proj, campos = _pose(cam)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        if not gram_relevancy:
            feats = render_language_feature_map_quick(
                merged_model, settings, view, proj, campos, bg, device=dev)
            return clip_model.get_max_across_quick(
                feats.permute(0, 2, 3, 1)), None
        settings = settings._replace(assemble=False)
        out = render(settings, merged_model, view, proj, campos, bg,
                     quick_render=True, device=dev, stage_events=stage_events)
        relev = clip_model.relevancy_from_tiles(
            out.language_feature_weight_map,
            *clip_model.prompt_constants(merged_model.codebooks),
            settings.grid_x, settings.grid_y, settings.image_height,
            settings.image_width, stage_events=stage_events)
    return relev, out


def evaluate_quick(merged_model: GaussianModel, cameras: list, gt_ann: dict,
                   image_shape: tuple[int, int],
                   clip_model: OpenCLIPNetwork | None = None,
                   mask_thresh: float = 0.4, logger=None,
                   gram_relevancy: bool = True, *, device=None,
                   stage_events: list | None = None):
    """Quick-path benchmark over the annotated frames (reference
    evaluate_quick, eval_lerf.py:293-371). `cameras[j]` belongs to
    annotation key str(j). Returns mean chosen IoU, localization accuracy,
    the chosen levels and the prompt count. `stage_events` (CUDA) gets the
    render stages of `render`, "query" and "relevancy", then
    "segmentation" and "localization" for each frame."""
    dev = resolve_device(device)
    clip_model = clip_model or OpenCLIPNetwork(device=dev)
    chosen_iou_all, chosen_lvl_list = [], []
    acc_num = total_prompts = 0
    for j_str, img_ann in gt_ann.items():
        prompts = list(img_ann.keys())
        clip_model.set_positives(prompts)
        valid_map, _ = quick_relevancy(
            merged_model, cameras[int(j_str)], clip_model, gram_relevancy,
            device=dev, stage_events=stage_events)
        c_iou, c_lvl, acc = _score_frame(valid_map, img_ann, prompts,
                                         mask_thresh, stage_events)
        chosen_iou_all.extend(c_iou)
        chosen_lvl_list.extend(c_lvl)
        acc_num += acc
        total_prompts += len(prompts)
        if logger:
            logger.info(f"frame {j_str}: iou {c_iou} lvl {c_lvl} "
                        f"acc {acc}/{len(prompts)}")
    return _summary(chosen_iou_all, chosen_lvl_list, acc_num, total_prompts)
