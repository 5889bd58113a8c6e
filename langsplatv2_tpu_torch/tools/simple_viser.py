"""A trained PLY as viser Gaussian splats, RGB only (port of
scripts/simple_viser.py; reference simple_viser.py):

    python -m langsplatv2_tpu_torch.tools.simple_viser --ply_path <ply>

`splat_arrays` turns the PLY into viser's arrays: centres [N, 3], the DC
colour sh * C0 + 0.5 clipped to [0, 1], sigmoid opacities [N, 1] and
world covariances [N, 3, 3]. viser is imported when served; without it
the tool prints so and exits with status 1, as the script does. The PLY
is read on the CPU (`--device` picks another).
"""
from __future__ import annotations

import sys
import time
from argparse import ArgumentParser

import numpy as np

from ..models.io import load_ply
from ..utils import transforms as tf
from ..utils.sh import C0


def unstrip_symmetric(c6: np.ndarray) -> np.ndarray:
    """[..., 6] (xx xy xz yy yz zz) -> [..., 3, 3] symmetric."""
    xx, xy, xz, yy, yz, zz = (c6[..., i] for i in range(6))
    return np.stack([np.stack([xx, xy, xz], -1), np.stack([xy, yy, yz], -1),
                     np.stack([xz, yz, zz], -1)], -2)


def splat_arrays(model) -> dict:
    """centers, rgbs, opacities, covariances as float32 numpy arrays."""
    def host(t):
        return t.detach().cpu().numpy().astype(np.float32)

    return dict(
        centers=host(model.xyz),
        rgbs=np.clip(host(model.features_dc[:, 0]) * C0 + 0.5, 0, 1),
        opacities=host(tf.opacity_activation(model.opacity)),
        covariances=unstrip_symmetric(host(model.get_covariance())))


def main(argv=None) -> None:
    parser = ArgumentParser()
    parser.add_argument("--ply_path", type=str, required=True)
    parser.add_argument("--port", type=int, default=8081)
    parser.add_argument("--max_sh_degree", type=int, default=3)
    parser.add_argument("--device", type=str, default="cpu")
    args = parser.parse_args(argv)

    try:
        import viser
    except ImportError:
        print("viser is not installed in this environment; "
              "install it to use the interactive viewer")
        sys.exit(1)

    arrays = splat_arrays(load_ply(args.ply_path, args.max_sh_degree,
                                   device=args.device))
    server = viser.ViserServer(port=args.port)
    server.scene.add_gaussian_splats("/splats", **arrays)
    print(f"serving {len(arrays['centers'])} splats on :{args.port}")
    while True:
        time.sleep(1.0)


if __name__ == "__main__":
    main()
