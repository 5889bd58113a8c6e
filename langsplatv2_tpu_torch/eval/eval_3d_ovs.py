"""The 3D-OVS benchmark command line (port of scripts/eval_3d_ovs.py;
reference eval_3d_ovs.py __main__, mask_thresh 0.25 as eval_3d_ovs.sh):

    python -m langsplatv2_tpu_torch.eval.eval_3d_ovs --dataset_name room \\
        --path_root <datasets_root> --ckpt_root <models_root>

The GT is <path_root>/<scene>/segmentations/<frame>/<prompt>.png; each
frame is scored from the camera whose image is named <frame>. The flags are
the script's, plus `--device` (default "cuda"). `main(argv)` returns the
dict it prints as JSON.
"""
from __future__ import annotations

import json
import os

from . import ovs
from .levels import benchmark_inputs, benchmark_parser
from .openclip import OpenCLIPNetwork


def main(argv=None) -> dict:
    args = benchmark_parser(mask_thresh=0.25).parse_args(argv)
    scene_dir, out_dir, models, merged, cameras, dev = benchmark_inputs(args)
    gt_ann, frame_ids = ovs.eval_gt_ovsdata(
        os.path.join(scene_dir, "segmentations"), out_dir)
    by_name = {c.image_name: c for c in cameras}
    cams_by_frame = {fid: by_name[fid] for fid in frame_ids if fid in by_name}
    clip_model = OpenCLIPNetwork(backend=args.clip_backend, device=dev)
    evaluate = ovs.evaluate_quick if args.quick else ovs.evaluate
    results = evaluate(merged if args.quick else models, cams_by_frame,
                       gt_ann, clip_model, mask_thresh=args.mask_thresh,
                       scene_name=args.dataset_name, device=dev)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
