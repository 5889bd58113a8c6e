"""Preprocessing command line (port of scripts/preprocess.py; reference
preprocess.py __main__): 4-level segmentation + CLIP encoding ->
<dataset>/language_features/<img>_{s,f}.npy.

    python -m langsplatv2_tpu_torch.preprocess.cli --dataset_path <scene> \\
        [--sam_ckpt ckpts/sam_vit_h_4b8939.pth] [--clip_backend auto] \\
        [--mask_backend auto|sam_jax|sam|cluster] [--device cuda]

The script's flags and choices, plus `--device` (default "cuda"; without
a card pass --device cpu). `main(argv)` returns a summary: the mask and
CLIP backends taken, the images and the output folder.
"""
from __future__ import annotations

import json
import os
import random
from argparse import ArgumentParser

import numpy as np
import torch

from ..device import resolve_device
from .pipeline import (ClusterMaskGenerator, PreprocessPipeline,
                       SamMaskGenerator, load_images)
from .sam import TorchSamMaskGenerator


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


def make_mask_generator(name: str, sam_ckpt: str, device):
    """(generator, the backend taken). "auto" tries the port's SAM, then
    upstream segment_anything, then the cluster segmenter."""
    if name == "sam_jax":
        return TorchSamMaskGenerator(checkpoint=sam_ckpt, device=device), name
    if name == "sam":
        return SamMaskGenerator(sam_ckpt, device=device), name
    if name == "cluster":
        return ClusterMaskGenerator(device=device), name
    try:
        return (TorchSamMaskGenerator(checkpoint=sam_ckpt, device=device),
                "sam_jax")
    except Exception as e1:
        try:
            return SamMaskGenerator(sam_ckpt, device=device), "sam"
        except Exception as e2:
            print(f"SAM unavailable (port: {e1}; upstream: {e2}); using "
                  "the cluster fallback segmenter")
            return ClusterMaskGenerator(device=device), "cluster"


def main(argv=None) -> dict:
    parser = ArgumentParser()
    parser.add_argument("--dataset_path", type=str, required=True)
    parser.add_argument("--resolution", type=int, default=1080)
    parser.add_argument("--sam_ckpt", type=str,
                        default="ckpts/sam_vit_h_4b8939.pth")
    parser.add_argument("--clip_backend", type=str, default="auto")
    parser.add_argument(
        "--mask_backend", type=str, default="auto",
        choices=["auto", "sam_jax", "sam", "cluster"],
        help='"sam_jax": this package\'s own torch SAM '
             '(preprocess/sam.py) on the checkpoint file; "sam": upstream '
             'segment_anything (needs the package); "cluster": the '
             'weights-free color/position k-means segmenter; "auto": '
             'sam_jax, then sam, then cluster')
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda, or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    seed_everything(42)

    images, names = load_images(args.dataset_path, args.resolution,
                                device=dev)
    print(f"loaded {len(images)} images")
    mask_generator, taken = make_mask_generator(args.mask_backend,
                                                args.sam_ckpt, dev)
    print(f"mask backend: {taken}")
    pipeline = PreprocessPipeline(mask_generator, args.clip_backend, dev)
    save_folder = os.path.join(args.dataset_path, "language_features")
    pipeline.run(images, names, save_folder)
    print(f"saved language features to {save_folder}")
    summary = {"mask_backend": taken, "clip_backend": pipeline.clip.name,
               "images": names, "save_folder": save_folder}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
