"""The render server's command line (port of scripts/backend_renderer.py;
reference backend_renderer.py __main__):

    python -m langsplatv2_tpu_torch.serve.backend_renderer \\
        --ckpt_paths <m1> <m2> <m3> --iteration 10000 --zmq_port 5555

Each <mi> is a feature-model directory holding chkpnt<iteration>.npz (or
the reference's `.pth`); the level models are merged into the
quick-render model and served by `serve/backend.py::BackendRenderer` over
ZMQ. The flags are the script's, plus `--device` (default "cuda").
`make_server(argv)` returns the server without running it.
"""
from __future__ import annotations

from argparse import ArgumentParser

from ..device import resolve_device
from ..eval.levels import add_device_flag, load_level_models
from ..eval.openclip import OpenCLIPNetwork
from .backend import BackendRenderer


def build_parser() -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--ckpt_paths", nargs="+", type=str, required=True)
    parser.add_argument("--iteration", type=int, default=10000)
    parser.add_argument("--zmq_port", type=int, default=5555)
    parser.add_argument("--white_background", action="store_true")
    parser.add_argument("--clip_backend", type=str, default="auto")
    parser.add_argument("--topk", type=int, default=4)
    parser.add_argument("--bf16_cells", action="store_true",
                        help="bf16 cell math in the fast16 blend (~1e-2 "
                             "relative)")
    parser.add_argument("--tile_budget", type=float, default=0.0,
                        help="> 0: budget-capped binning, per-tile work "
                             "bounded by a transmittance budget "
                             "(approximate; see RasterizeSettings)")
    parser.add_argument("--tile_budget_cap", type=int, default=256)
    parser.add_argument("--tile_budget_subdiv", type=int, default=2)
    add_device_flag(parser)
    return parser


def make_server(argv=None, **server_kwargs) -> BackendRenderer:
    """The server the command line runs; `server_kwargs` go to
    BackendRenderer as well (e.g. compose="device")."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    _, merged = load_level_models(args.ckpt_paths, args.iteration, args.topk,
                                  device=dev)
    bg = (1.0, 1.0, 1.0) if args.white_background else (0.0, 0.0, 0.0)
    return BackendRenderer(
        merged, zmq_port=args.zmq_port, background=bg,
        clip_model=OpenCLIPNetwork(backend=args.clip_backend, device=dev),
        bf16_cells=args.bf16_cells, tile_budget=args.tile_budget,
        tile_budget_cap=args.tile_budget_cap,
        tile_budget_subdiv=args.tile_budget_subdiv, device=dev,
        **server_kwargs)


def main(argv=None) -> None:
    make_server(argv).run()


if __name__ == "__main__":
    main()
