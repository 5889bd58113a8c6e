"""The LERF benchmark command line (port of scripts/eval_lerf.py; reference
eval_lerf.py __main__):

    python -m langsplatv2_tpu_torch.eval.eval_lerf --dataset_name teatime \\
        --path_root <datasets_root> --ckpt_root <models_root> \\
        --output_root <out> --iteration 10000 --mask_thresh 0.4

The level models are read from
<ckpt_root>/<scene>_<index>_<level>/chkpnt<iteration>.npz (or `.pth`),
the labelme GT from <path_root>/<scene>/label/, and the masks written to
<output_root>/<scene>/gt/. The flags are the script's, plus `--device`
(default "cuda"). `main(argv)` returns the dict it prints as JSON.
"""
from __future__ import annotations

import json
import logging
import os
from datetime import datetime

from . import lerf
from .levels import benchmark_inputs, benchmark_parser
from .openclip import OpenCLIPNetwork


def get_logger(name: str, log_file: str | None, log_level=logging.INFO):
    """The script's logger: to the console and, given a path, to a file
    (the handlers of an earlier run in the process are closed first)."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.addHandler(logging.StreamHandler())
    if log_file is not None:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        logger.addHandler(logging.FileHandler(log_file, "w"))
    logger.setLevel(log_level)
    return logger


def main(argv=None) -> dict:
    args = benchmark_parser(mask_thresh=0.4).parse_args(argv)
    scene_dir, out_dir, models, merged, cameras, dev = benchmark_inputs(args)
    os.makedirs(out_dir, exist_ok=True)
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    logger = get_logger(args.dataset_name, os.path.join(out_dir, f"{ts}.log"))
    gt_ann, (gt_h, gt_w), _ = lerf.eval_gt_lerfdata(
        os.path.join(scene_dir, "label"), out_dir)
    clip_model = OpenCLIPNetwork(backend=args.clip_backend, device=dev)
    if args.quick:
        results = lerf.evaluate_quick(
            merged, cameras, gt_ann, (gt_h, gt_w), clip_model,
            mask_thresh=args.mask_thresh, logger=logger, device=dev)
    else:
        results = lerf.evaluate(
            models, cameras, gt_ann, (gt_h, gt_w), clip_model,
            mask_thresh=args.mask_thresh, logger=logger, device=dev)
    logger.info(json.dumps(results))
    summary = {"mean_iou": results["mean_iou"],
               "localization_accuracy": results["localization_accuracy"]}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
