"""What the benchmark command lines and the render-server command line
share (port of the common part of scripts/eval_{lerf,3d_ovs,mip_nerf360}.py
and scripts/backend_renderer.py): their flags, the per-level models read
from `<ckpt_root>/<scene>_<index>_<level>/chkpnt<iteration>.npz` (or the
reference's `.pth`) and merged into the quick-render model, and the
scene's cameras in name order.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

from ..device import resolve_device
from ..models.io import load_checkpoint_auto, resolve_checkpoint
from ..scene.scene import Scene
from .lerf import merge_level_models


def add_device_flag(parser: ArgumentParser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda, or cpu for the kernels' plain versions")


def benchmark_parser(mask_thresh: float) -> ArgumentParser:
    """The flags of scripts/eval_{lerf,3d_ovs,mip_nerf360}.py (their
    mask_thresh defaults differ), plus --device."""
    parser = ArgumentParser()
    parser.add_argument("--dataset_name", type=str, required=True)
    parser.add_argument("--path_root", type=str, required=True,
                        help="root containing <scene>/ with colmap data + "
                             "label/ or segmentations/")
    parser.add_argument("--ckpt_root", type=str, required=True)
    parser.add_argument("--output_root", type=str, default="eval_out")
    parser.add_argument("--iteration", type=int, default=10000)
    parser.add_argument("--index", type=int, default=1,
                        help="run index in the model dir naming "
                             "<scene>_<idx>_<level>")
    parser.add_argument("--mask_thresh", type=float, default=mask_thresh)
    parser.add_argument("--levels", nargs="+", type=int, default=[1, 2, 3])
    parser.add_argument("--topk", type=int, default=4)
    parser.add_argument("--clip_backend", type=str, default="auto")
    parser.add_argument("--resolution", type=int, default=-1)
    # Reference `evaluate`: the level models scored separately with the
    # full per-level decode instead of the merged quick render.
    parser.add_argument("--no-quick", dest="quick", action="store_false",
                        default=True)
    add_device_flag(parser)
    return parser


def load_level_models(model_dirs: list[str], iteration: int, topk: int = 4,
                      *, device=None):
    """Each directory's chkpnt<iteration> (`.npz` first, then `.pth`),
    and their merge: (models, merged)."""
    dev = resolve_device(device)
    models = [load_checkpoint_auto(resolve_checkpoint(d, iteration),
                                   device=dev)[0] for d in model_dirs]
    return models, merge_level_models(models, topk=topk)


def benchmark_inputs(args):
    """(scene_dir, out_dir, models, merged, cameras, device) of a
    benchmark run: the level models of args.levels, the scene's training
    cameras unshuffled (eval_split=False). Writes nothing; the device is
    resolved first."""
    dev = resolve_device(args.device)
    scene_dir = os.path.join(args.path_root, args.dataset_name)
    out_dir = os.path.join(args.output_root, args.dataset_name)
    models, merged = load_level_models(
        [os.path.join(args.ckpt_root,
                      f"{args.dataset_name}_{args.index}_{level}")
         for level in args.levels], args.iteration, args.topk, device=dev)
    scene = Scene(scene_dir, model_path="", resolution=args.resolution,
                  eval_split=False, shuffle=False)
    return (scene_dir, out_dir, models, merged, scene.get_train_cameras(),
            dev)
