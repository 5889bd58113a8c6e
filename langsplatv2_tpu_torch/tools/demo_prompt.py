"""A prompt's heatmap frames over every Nth camera (port of
scripts/demo_prompt.py; reference demo_prompt.py):

    python -m langsplatv2_tpu_torch.tools.demo_prompt \\
        --ckpt_paths <out>_1 <out>_2 <out>_3 -s <scene> --prompt "teddy bear"

The level checkpoints are merged into one quick model; each frame renders
its RGB and its 192-channel map, decodes and normalizes the level sum,
takes the cosine with the prompt, applies the script's "smart contrast"
(sim**4, zero below threshold**4, divided by the largest) and blends a
JET heatmap over the RGB where sim > 0. Frames are written as
<output_dir>/frame_NNNN.png with PIL (the script writes the same pixels
with cv2). The flags are the script's, plus `--device` (default "cuda");
--clip_backend defaults to "hash", as the port's eval modules do.
`main(argv)` returns the written paths.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch

from ..device import resolve_device
from ..eval.colormaps import apply_jet_u8
from ..eval.lerf import merge_level_models, render_language_feature_map_quick
from ..eval.openclip import OpenCLIPNetwork
from ..models.io import load_checkpoint_auto, resolve_checkpoint
from ..models.renderer import make_settings, render
from ..scene.scene import Scene


def heatmap_frame(merged, cam, text: np.ndarray, threshold: float, *,
                  device=None) -> dict:
    """One frame: rgb [H, W, 3] in [0, 1], sim [H, W] after the contrast,
    frame [H, W, 3] u8 (the PNG's pixels). `text` [512] normalized."""
    dev = resolve_device(device)
    settings = make_settings(cam, merged.active_sh_degree)
    view = np.asarray(cam.world_view_transform, np.float32)
    proj = np.asarray(cam.full_proj_transform, np.float32)
    campos = np.asarray(cam.camera_center, np.float32)
    bg = np.zeros(3, np.float32)
    with torch.no_grad():
        rgb = render(settings, merged, view, proj, campos, bg,
                     device=dev).render
        rgb = torch.clamp(rgb.permute(1, 2, 0), 0, 1).cpu().numpy()
        lf = render_language_feature_map_quick(
            merged, settings, view, proj, campos, bg, device=dev)
        lf_sum = lf.sum(0)
        lf_sum = lf_sum / (torch.linalg.norm(lf_sum, dim=0, keepdim=True)
                           + 1e-10)
        sim = torch.einsum("dhw,d->hw", lf_sum, torch.as_tensor(
            text, dtype=torch.float32, device=dev)).cpu().numpy()
    # Smart contrast (reference demo_prompt.py:110-158).
    sim = np.clip(sim, 0, 1) ** 4
    sim = np.where(sim > threshold ** 4, sim, 0.0)
    if sim.max() > 0:
        sim = sim / sim.max()
    heat = apply_jet_u8((sim * 255).astype(np.uint8)) / 255.0
    blend = np.where(sim[..., None] > 0, rgb * 0.4 + heat * 0.6, rgb)
    return dict(rgb=rgb, sim=sim, frame=(blend * 255).astype(np.uint8))


def main(argv=None) -> list:
    parser = ArgumentParser()
    parser.add_argument("--ckpt_paths", nargs="+", type=str, required=True)
    parser.add_argument("--iteration", type=int, default=10000)
    parser.add_argument("--source_path", type=str, required=True)
    parser.add_argument("--prompt", type=str, required=True)
    parser.add_argument("--threshold", type=float, default=0.22)
    parser.add_argument("--every", type=int, default=20)
    parser.add_argument("--resolution", type=int, default=-1)
    parser.add_argument("--output_dir", type=str, default="demo_frames")
    parser.add_argument("--clip_backend", type=str, default="hash")
    parser.add_argument("--topk", type=int, default=4)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from PIL import Image

    dev = resolve_device(args.device)
    models = [load_checkpoint_auto(resolve_checkpoint(p, args.iteration),
                                   device=dev)[0] for p in args.ckpt_paths]
    merged = merge_level_models(models, topk=args.topk)
    scene = Scene(args.source_path, model_path="",
                  resolution=args.resolution, shuffle=False)
    cameras = scene.get_train_cameras()[::args.every]
    clip = OpenCLIPNetwork(backend=args.clip_backend, device=dev)
    text = clip.encode_text([args.prompt]).cpu().numpy()
    text = text / np.linalg.norm(text, axis=-1, keepdims=True)
    os.makedirs(args.output_dir, exist_ok=True)
    paths = []
    for i, cam in enumerate(cameras):
        out = heatmap_frame(merged, cam, text[0], args.threshold, device=dev)
        path = os.path.join(args.output_dir, f"frame_{i:04d}.png")
        Image.fromarray(out["frame"]).save(path)
        print(path)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
