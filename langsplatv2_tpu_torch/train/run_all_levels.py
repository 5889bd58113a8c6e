"""The whole training pipeline of a scene (port of
scripts/run_all_levels.sh; reference run_all_levels.sh):

    python -m langsplatv2_tpu_torch.train.run_all_levels <scene> <out> \\
        [levels ...] [--device cpu]

The geometry phase to <out>_-1/chkpnt$ITER_RGB.npz (skipped when that
checkpoint exists), then a feature phase for each level (default 1 2 3)
from it at `-r 2` into <out>_<level>/, through `train/cli.py::main`.
ITER_RGB (default 30000) and ITER_FEAT (10000) are read from the
environment, as the script reads them. `main(argv)` returns the runs'
summaries.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

from . import cli


def main(argv=None) -> list:
    parser = ArgumentParser(description="geometry, then each feature level")
    parser.add_argument("scene")
    parser.add_argument("output_root")
    parser.add_argument("levels", nargs="*", type=int, default=[1, 2, 3])
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda, or cpu for the kernels' plain versions")
    args = parser.parse_args(argv)
    iter_rgb = os.environ.get("ITER_RGB", "30000")
    iter_feat = os.environ.get("ITER_FEAT", "10000")
    common = ["-s", args.scene, "-m", args.output_root, "--device",
              args.device]
    rgb_ckpt = f"{args.output_root}_-1/chkpnt{iter_rgb}.npz"
    summaries = []
    if not os.path.isfile(rgb_ckpt):
        summaries.append(cli.main(common + [
            "--iterations", iter_rgb, "--save_iterations", iter_rgb,
            "--checkpoint_iterations", iter_rgb]))
        if not os.path.isfile(rgb_ckpt):
            raise SystemExit(f"RGB checkpoint not created at {rgb_ckpt}")
    for level in args.levels:
        summaries.append(cli.main(common + [
            "-r", "2", "--include_feature", "--feature_level", str(level),
            "--start_checkpoint", rgb_ckpt, "--vq_layer_num", "1",
            "--codebook_size", "64", "--cos_loss", "--topk", "4",
            "--iterations", iter_feat, "--save_iterations", iter_feat,
            "--checkpoint_iterations", iter_feat]))
    return summaries


if __name__ == "__main__":
    main()
