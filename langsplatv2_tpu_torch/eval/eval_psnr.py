"""The RGB PSNR command line (port of scripts/eval_psnr.py; reference
eval_araba.py:13-51):

    python -m langsplatv2_tpu_torch.eval.eval_psnr -s <scene> -m <model_dir>

Renders every test camera of the scene (its first 10 training cameras when
it has no test split) from <model_dir>/chkpnt<iteration>.npz (the highest
iteration found under --iteration -1) and prints each image's PSNR, the
mean, and a JSON line. The flags are the script's, plus `--device`
(default "cuda"). `main(argv)` returns the dict of the JSON line.
"""
from __future__ import annotations

import glob
import json
import os
import re
import sys
from argparse import ArgumentParser

from ..device import resolve_device
from ..models.io import load_checkpoint_auto
from ..scene.scene import Scene
from .levels import add_device_flag
from .psnr_eval import evaluate_psnr


def latest_iteration(model_path: str) -> int:
    """The highest N of the chkpnt<N>.npz files in a model directory."""
    cands = glob.glob(os.path.join(model_path, "chkpnt*.npz"))
    if not cands:
        sys.exit(f"no checkpoints under {model_path}")
    return max(int(re.search(r"chkpnt(\d+)\.npz$", c).group(1))
               for c in cands)


def main(argv=None) -> dict:
    parser = ArgumentParser(description="RGB PSNR evaluation")
    parser.add_argument("-s", "--source_path", type=str, required=True)
    parser.add_argument("-m", "--model_path", type=str, required=True,
                        help="model dir containing chkpnt<iteration>.npz")
    parser.add_argument("--iteration", type=int, default=-1,
                        help="-1 = highest checkpoint iteration found")
    parser.add_argument("--resolution", type=int, default=-1)
    parser.add_argument("--white_background", action="store_true")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--quiet", action="store_true")
    add_device_flag(parser)
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    if args.iteration == -1:
        args.iteration = latest_iteration(args.model_path)
    ckpt = os.path.join(args.model_path, f"chkpnt{args.iteration}.npz")
    print(f"Loading model from {ckpt}")
    model, _ = load_checkpoint_auto(ckpt, device=dev)

    scene = Scene(args.source_path, model_path="", resolution=args.resolution,
                  eval_split=True, shuffle=False)
    cameras = scene.get_test_cameras()
    if not cameras:
        print("No test cameras found - using first 10 train cameras.")
        cameras = scene.get_train_cameras()[:10]
    print(f"Evaluating on {len(cameras)} images...")

    bg = (1.0, 1.0, 1.0) if args.white_background else (0.0, 0.0, 0.0)
    mean_psnr, per_cam = evaluate_psnr(model, cameras, bg=bg,
                                       limit=args.limit, device=dev)
    if not args.quiet:
        for cam, p in zip(cameras, per_cam):
            print(f"Image {cam.image_name}: PSNR = {p:.4f}")
    print(f"Average PSNR: {mean_psnr:.4f}")
    summary = {"mean_psnr": mean_psnr, "num_images": len(per_cam)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
