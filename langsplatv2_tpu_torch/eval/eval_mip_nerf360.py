"""The Mip-NeRF360 benchmark command line (port of
scripts/eval_mip_nerf360.py; reference eval_mip_nerf360.py __main__,
mask_thresh 0.4 as eval_mip_nerf360.sh):

    python -m langsplatv2_tpu_torch.eval.eval_mip_nerf360 \\
        --dataset_name garden --path_root <datasets_root> \\
        --ckpt_root <models_root>

The labelme GT is read from <path_root>/<scene>/label/ as for LERF. The
flags are the script's, plus `--device` (default "cuda"). `main(argv)`
returns the dict it prints as JSON.
"""
from __future__ import annotations

import json
import os

from . import lerf, mip360
from .levels import benchmark_inputs, benchmark_parser
from .openclip import OpenCLIPNetwork


def main(argv=None) -> dict:
    args = benchmark_parser(mask_thresh=0.4).parse_args(argv)
    scene_dir, out_dir, models, merged, cameras, dev = benchmark_inputs(args)
    gt_ann, (h, w), _ = lerf.eval_gt_lerfdata(
        os.path.join(scene_dir, "label"), out_dir)
    clip_model = OpenCLIPNetwork(backend=args.clip_backend, device=dev)
    evaluate = mip360.evaluate_quick if args.quick else mip360.evaluate
    results = evaluate(merged if args.quick else models, cameras, gt_ann,
                       (h, w), clip_model, mask_thresh=args.mask_thresh,
                       device=dev)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
