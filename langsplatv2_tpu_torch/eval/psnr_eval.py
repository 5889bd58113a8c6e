"""RGB quality evaluation: PSNR over held-out cameras (port of
langsplatv2_tpu/eval/psnr_eval.py; reference eval_araba.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.renderer import make_settings, render
from ..utils.losses import psnr


def evaluate_psnr(model, cameras, bg=(0.0, 0.0, 0.0),
                  limit: int | None = None, *, device=None):
    """Each camera (world_view_transform, full_proj_transform,
    camera_center, image [3, H, W] in [0, 1]) rendered and held to its
    image. Returns (mean PSNR, per-camera list)."""
    dev = resolve_device(device)
    cams = cameras[:limit] if limit else cameras
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    values = []
    with torch.no_grad():
        for cam in cams:
            settings = make_settings(cam, model.active_sh_degree)
            out = render(settings, model,
                         np.asarray(cam.world_view_transform, np.float32),
                         np.asarray(cam.full_proj_transform, np.float32),
                         np.asarray(cam.camera_center, np.float32), bg,
                         device=dev)
            pred = torch.clamp(out.render, 0.0, 1.0)[None]
            gt = torch.clamp(torch.as_tensor(cam.image, dtype=torch.float32,
                                             device=dev), 0.0, 1.0)[None]
            values.append(float(psnr(pred, gt)[0, 0]))
    return float(np.mean(values)) if values else 0.0, values
