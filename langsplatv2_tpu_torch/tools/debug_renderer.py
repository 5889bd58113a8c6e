"""Logit statistics, an RGB panel and per-prompt similarity panels of a
checkpoint (port of scripts/debug_renderer.py; reference
debug_renderer.py):

    python -m langsplatv2_tpu_torch.tools.debug_renderer \\
        --checkpoint <out>_1/chkpnt10000.npz -s <scene> --prompts car tree

Prints the checkpoint's iteration, live count and logit statistics, then
renders one training camera: the RGB frame and, for a feature checkpoint,
its top-k weight map decoded to 512-d, normalized, and its cosine with
each prompt. The script draws these with matplotlib (sims under the
"jet" map, scaled to each panel's range); here the panels are composed
with PIL (the card's machine has no matplotlib): the RGB, then each
prompt's similarity through the same min-max scaling and OpenCV's JET
table, titled, side by side. The flags are the script's, plus `--device`
(default "cuda"); --clip_backend defaults to "hash". `main(argv)`
returns the panels' arrays (`panels`).
"""
from __future__ import annotations

from argparse import ArgumentParser

import numpy as np
import torch

from ..device import resolve_device
from ..eval.colormaps import apply_jet_u8
from ..eval.openclip import OpenCLIPNetwork
from ..models.io import load_checkpoint_auto
from ..models.renderer import make_settings, render
from ..scene.scene import Scene


def logit_stats(model) -> dict | None:
    """mean, std, min, max of the language logits (None without them)."""
    if model.language_logits is None:
        return None
    lg = model.language_logits.detach().cpu().numpy()
    return dict(mean=float(lg.mean()), std=float(lg.std()),
                min=float(lg.min()), max=float(lg.max()))


def panels(model, cam, text: np.ndarray | None, topk: int = 4, *,
           device=None) -> dict:
    """rgb [H, W, 3] in [0, 1], and with `text` [P, 512] (normalized) and
    a feature checkpoint sims [H, W, P]."""
    dev = resolve_device(device)
    settings = make_settings(cam, model.active_sh_degree)
    view = np.asarray(cam.world_view_transform, np.float32)
    proj = np.asarray(cam.full_proj_transform, np.float32)
    campos = np.asarray(cam.camera_center, np.float32)
    bg = np.zeros(3, np.float32)
    res = {}
    with torch.no_grad():
        out = render(settings, model, view, proj, campos, bg, device=dev)
        res["rgb"] = torch.clamp(out.render.permute(1, 2, 0), 0,
                                 1).cpu().numpy()
        if model.language_logits is not None and text is not None:
            outf = render(settings, model, view, proj, campos, bg,
                          include_feature=True, topk=topk, device=dev)
            feat = model.compute_final_feature_map(
                outf.language_feature_weight_map)
            feat = feat / (torch.linalg.norm(feat, dim=0, keepdim=True)
                           + 1e-10)
            res["sims"] = torch.einsum(
                "dhw,pd->hwp", feat, torch.as_tensor(
                    text, dtype=torch.float32, device=dev)).cpu().numpy()
    return res


def compose(res: dict, titles: list) -> "Image.Image":
    """The panels side by side, each under its title."""
    from PIL import Image, ImageDraw

    tiles = [(res["rgb"] * 255).astype(np.uint8)]
    for i in range(res["sims"].shape[-1] if "sims" in res else 0):
        s = res["sims"][..., i]
        span = float(s.max() - s.min())
        norm = (s - s.min()) / span if span > 0 else np.zeros_like(s)
        tiles.append(apply_jet_u8((norm * 255).astype(np.uint8)))
    h, w, _ = tiles[0].shape
    head = 16
    sheet = Image.new("RGB", (w * len(tiles), h + head), "white")
    draw = ImageDraw.Draw(sheet)
    for j, (tile, title) in enumerate(zip(tiles, titles)):
        sheet.paste(Image.fromarray(tile), (j * w, head))
        draw.text((j * w + 2, 2), title, fill="black")
    return sheet


def main(argv=None) -> dict:
    parser = ArgumentParser()
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--source_path", type=str, required=True)
    parser.add_argument("--resolution", type=int, default=-1)
    parser.add_argument("--camera_index", type=int, default=0)
    parser.add_argument("--prompts", nargs="+", type=str,
                        default=["car", "tree", "road"])
    parser.add_argument("--topk", type=int, default=4)
    parser.add_argument("--output", type=str,
                        default="debug_render_result.png")
    parser.add_argument("--clip_backend", type=str, default="hash")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    model, it = load_checkpoint_auto(args.checkpoint, device=dev)
    print(f"checkpoint iteration {it}, {int(model.num_live)} live gaussians")
    stats = logit_stats(model)
    if stats is not None:
        print(f"logits: mean {stats['mean']:.4f} std {stats['std']:.4f} "
              f"min {stats['min']:.4f} max {stats['max']:.4f}")
    scene = Scene(args.source_path, model_path="",
                  resolution=args.resolution, shuffle=False)
    cam = scene.get_train_cameras()[args.camera_index]
    text = None
    if model.language_logits is not None:
        clip = OpenCLIPNetwork(backend=args.clip_backend, device=dev)
        text = clip.encode_text(args.prompts).cpu().numpy()
        text = text / np.linalg.norm(text, axis=-1, keepdims=True)
    res = panels(model, cam, text, args.topk, device=dev)
    titles = [f"RGB (iter {it})"] + [f"Sim: {p}" for p in args.prompts]
    compose(res, titles).save(args.output)
    print(f"saved {args.output}")
    return dict(iteration=it, logit_stats=stats, panels=res,
                output=args.output)


if __name__ == "__main__":
    main()
