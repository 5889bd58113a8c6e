"""The training command line (port of scripts/train.py; reference
train.py __main__):

    python -m langsplatv2_tpu_torch.train.cli -s <scene> -m <out>
    python -m langsplatv2_tpu_torch.train.cli -s <scene> -m <out> \\
        --include_feature --start_checkpoint <out>_-1/chkpnt30000.npz \\
        --feature_level L --cos_loss --topk 4

The flags are scripts/train.py's, plus `--device` (default "cuda"; "cpu"
runs the kernels' plain versions). The model directory gets what
scripts/train.py writes: `<out>_<feature_level>/` with cfg_args and
cfg_args.json, cameras.json, input.ply,
point_cloud/iteration_N/point_cloud.ply, chkpntN.npz and metrics.jsonl.
A feature phase starts from a checkpoint without language fields: random
logits and codebooks from the residual k-means over the scene's 2-D CLIP
features (`language_features/*_f.npy`), both drawn from torch generators
seeded from --seed (so not the JAX package's values). A checkpoint of the
same phase resumes at its iteration with its Adam moments (`.npz`, or the
reference's `.pth`); a feature checkpoint keeps its trained logits and
codebooks (the JAX script draws them anew). `--profile_dir` writes a
torch.profiler trace of iterations [100, 110). `--impl xla` and `--gui`
belong to later slices and raise.

`main(argv)` runs in process and returns a summary (the model directory,
first and last iteration, losses, each iteration's host time and
expansion total, the feature phase's entry budgets, the scene load and
k-means times); it puts back the sys.stdout that `safe_state` replaces.
"""
from __future__ import annotations

import glob
import json
import os
import sys
import time
from argparse import ArgumentParser, Namespace

import numpy as np
import torch

from ..device import resolve_device
from ..models import io as mio
from ..models.gaussians import create_from_pcd, init_language_features
from ..models.renderer import make_settings, render
from ..scene.scene import Scene
from ..utils import losses
from ..utils.sparse_codes import residual_kmeans_codebooks
from ..utils.system import safe_state
from . import trainer
from .config import (ModelParams, OptimizationParams, PipelineParams,
                     save_cfg_args)

DEFAULT_MARKS = [2000, 4000, 6000, 8000, 10_000, 30_000]


def build_parser():
    """(parser, model group, optimization group, pipeline group)."""
    parser = ArgumentParser(description="Training script parameters")
    lp = ModelParams(parser)
    op = OptimizationParams(parser)
    pp = PipelineParams(parser)
    for name in ("test", "save", "checkpoint"):
        parser.add_argument(f"--{name}_iterations", nargs="+", type=int,
                            default=list(DEFAULT_MARKS))
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--gui", action="store_true", default=False)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--cos_loss", action="store_true", default=False)
    parser.add_argument("--l1_loss", action="store_true", default=False)
    parser.add_argument("--normalize", action="store_true", default=False)
    parser.add_argument("--accum_iter", type=int, default=1)
    parser.add_argument(
        "--cam_batch", type=int, default=1,
        help="Feature phase, gram config only: N cameras a step (summed "
             "grads, one update), the top-k pass and Adam once a group")
    parser.add_argument("--topk", type=int, default=1)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tile_cap", type=int, default=1024)
    parser.add_argument("--max_entries", type=int, default=2 ** 21)
    parser.add_argument(
        "--tile_budget", type=float, default=0.0,
        help="Feature phase only: budget-capped binning (each tile's "
             "transmittance-bound depth prefix in a [tiles, cap] layout; "
             "0 disables)")
    parser.add_argument("--tile_budget_cap", type=int, default=128)
    parser.add_argument("--tile_budget_subdiv", type=int, default=2)
    parser.add_argument("--cull_alpha", type=float, default=1.0 / 255.0,
                        help="expansion exact-cull alpha threshold")
    parser.add_argument("--impl", type=str, default="auto",
                        choices=["auto", "xla", "pallas"])
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="torch.profiler trace of iterations [100, 110)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda, or cpu for the kernels' plain versions")
    return parser, lp, op, pp


def load_2d_features(lf_path: str):
    """The scene's 2-D CLIP feature tables (`*f.npy`, in name order)
    stacked [M, 512], or None."""
    names = sorted(glob.glob(os.path.join(lf_path, "*f.npy")))
    if not names:
        return None
    return np.concatenate([np.load(n) for n in names], axis=0)


def main(argv=None) -> dict:
    parser, lp, op, _ = build_parser()
    args = parser.parse_args(argv)
    if args.impl == "xla":
        raise NotImplementedError(
            '--impl xla belongs to a later slice of the port: ROADMAP.md '
            'Queue 1 item 4, the differentiable reference rasterizer')
    if args.gui:
        raise NotImplementedError(
            "--gui belongs to a later slice of the port: ROADMAP.md Queue 1 "
            "item 9, the viewer")
    dev = resolve_device(args.device)
    args.save_iterations.append(args.iterations)
    # The reference appends the feature level to the model dir
    # (train.py:354).
    args.model_path = args.model_path + f"_{args.feature_level}"
    print("Optimizing " + args.model_path)
    stdout = safe_state(args.quiet, seed=args.seed)
    try:
        return _train(args, lp.extract(args), op.extract(args), dev)
    finally:
        sys.stdout = stdout


def _train(args, dataset, opt, dev) -> dict:
    os.makedirs(args.model_path, exist_ok=True)
    save_cfg_args(args.model_path, Namespace(**vars(args)))
    t0 = time.perf_counter()
    scene = Scene(dataset.source_path, args.model_path,
                  images=dataset.images, resolution=dataset.resolution,
                  white_background=dataset.white_background,
                  eval_split=dataset.eval)
    cameras = scene.get_train_cameras()
    summary = {"model_path": args.model_path,
               "scene_s": time.perf_counter() - t0, "kmeans_s": None}
    print(f"Scene: {len(cameras)} training cameras in "
          f"{summary['scene_s']:.2f} s")
    bg = (1.0, 1.0, 1.0) if dataset.white_background else (0.0, 0.0, 0.0)

    first_iter = 0
    resume = None
    if opt.include_feature and not args.start_checkpoint:
        raise ValueError("checkpoint missing!!!!!")
    if args.start_checkpoint:
        model, ckpt_iter = mio.load_checkpoint_auto(
            args.start_checkpoint, dataset.sh_degree, device=dev)
        if model.language_logits is not None or not opt.include_feature:
            # Same-phase resume: its moments are restored below.
            first_iter, resume = ckpt_iter, args.start_checkpoint
    else:
        n = np.asarray(scene.points).shape[0]
        model = create_from_pcd(
            np.asarray(scene.points, np.float32),
            np.asarray(scene.colors, np.float32),
            spatial_lr_scale=scene.cameras_extent,
            max_sh_degree=dataset.sh_degree, capacity=-(-n // 256) * 256,
            device=dev)

    metrics_file = open(os.path.join(args.model_path, "metrics.jsonl"), "a")
    test_cams = scene.get_test_cameras()
    # The reference's training_report also samples 5 spaced training
    # cameras (train.py:303-306).
    train_sample = ([cameras[i % len(cameras)] for i in range(5, 30, 5)]
                    if cameras else [])
    profiler = [None]
    clock = [time.perf_counter()]
    iteration_ms: list = []
    total_entries: list = []

    @torch.no_grad()
    def eval_split(model, cams):
        l1s, psnrs = [], []
        for cam in cams:
            settings = make_settings(cam, model.active_sh_degree, 1.0,
                                     args.max_entries)
            out = render(settings, model, cam.world_view_transform,
                         cam.full_proj_transform, cam.camera_center,
                         np.asarray(bg, np.float32), device=dev)
            img = torch.clamp(out.render, 0.0, 1.0)
            gt = torch.as_tensor(cam.image, device=dev)
            l1s.append(float(losses.l1_loss(img, gt)))
            psnrs.append(float(losses.psnr(img[None], gt[None])[0, 0]))
        return float(np.mean(l1s)), float(np.mean(psnrs))

    def maybe_profile(iteration):
        if args.profile_dir is None:
            return
        if iteration == 100:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler[0] = torch.profiler.profile(activities=activities)
            profiler[0].start()
        elif iteration == 110 and profiler[0] is not None:
            profiler[0].stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            profiler[0].export_chrome_trace(
                os.path.join(args.profile_dir, "trace.json"))
            profiler[0] = None
            print(f"profiler trace written to {args.profile_dir}")

    def training_report(iteration, model, metrics, phase):
        """Scalars to metrics.jsonl every 10 iterations; the test split's
        and a training sample's L1 / PSNR at --test_iterations (reference
        train.py:292-328, JSONL in place of tensorboard)."""
        maybe_profile(iteration)
        if iteration % 10 == 0 or iteration in args.test_iterations:
            row = {"iter": iteration, "phase": phase,
                   "loss": round(float(metrics["loss"]), 6),
                   "num_live": int(model.num_live)}
            if "l1" in metrics:
                row["l1"] = round(float(metrics["l1"]), 6)
            metrics_file.write(json.dumps(row) + "\n")
            metrics_file.flush()
        if iteration in args.test_iterations:
            for split, cams in (("test", test_cams), ("train", train_sample)):
                if not cams:
                    continue
                l1, ps = eval_split(model, cams)
                print(f"\n[ITER {iteration}] Evaluating {split}: "
                      f"L1 {l1:.6f} PSNR {ps:.3f}")
                metrics_file.write(json.dumps(
                    {"iter": iteration, "phase": phase, "split": split,
                     "l1": round(l1, 6), "psnr": round(ps, 4)}) + "\n")
                metrics_file.flush()

    def save_outputs(iteration, model, optimizer, phase):
        if iteration in args.save_iterations:
            mio.save_ply(model, os.path.join(
                args.model_path, "point_cloud", f"iteration_{iteration}",
                "point_cloud.ply"))
        if (iteration in args.checkpoint_iterations
                or iteration == args.iterations):
            # The Adam moments too, as the reference's capture() keeps them
            # (gaussian_model.py:67-101).
            mio.save_checkpoint(
                os.path.join(args.model_path, f"chkpnt{iteration}.npz"),
                model, optimizer, iteration, extra={"phase": phase})

    def restore_optimizer(optimizer, model):
        """Same-phase resume: the checkpoint's Adam state into `optimizer`
        (fresh moments, with a warning, when it does not fit)."""
        if resume is None:
            return optimizer
        try:
            if resume.endswith((".pth", ".pt")):
                from ..models.torch_interop import (convert_torch_adam_state,
                                                    load_torch_checkpoint)
                opt_dict = load_torch_checkpoint(resume, device=dev)[2]
                convert_torch_adam_state(opt_dict, optimizer, model.capacity)
            else:
                mio.load_optimizer_state(resume, optimizer)
        except (ValueError, KeyError, OSError, RuntimeError) as e:
            print(f"WARNING: could not restore optimizer state ({e}); "
                  "resuming with fresh moments")
        return optimizer

    def on_iter_for(phase):
        def on_iter(it, m, optimizer, metrics):
            if it % 100 == 0:
                print(f"Iter {it} Loss: {float(metrics['loss']):.6f}"
                      + (f" live: {int(m.num_live)}" if phase == "rgb"
                         else ""))
            now = time.perf_counter()
            iteration_ms.append((now - clock[0]) * 1e3)
            total_entries.append(int(metrics["total_entries"]))
            training_report(it, m, metrics, phase)
            save_outputs(it, m, optimizer, phase)
            clock[0] = time.perf_counter()
        return on_iter

    try:
        if opt.include_feature:
            phase = "feature"
            if resume is None:
                # Codebooks from the 2-D CLIP features (reference
                # train.py:78-85).
                gen = torch.Generator(device=dev).manual_seed(args.seed)
                model = init_language_features(
                    model, opt.vq_layer_num, opt.codebook_size,
                    generator=gen)
                feats = load_2d_features(dataset.lf_path)
                if feats is not None:
                    t0 = time.perf_counter()
                    books = residual_kmeans_codebooks(
                        torch.from_numpy(np.asarray(feats, np.float32)).to(
                            dev), opt.vq_layer_num, opt.codebook_size,
                        generator=torch.Generator(device=dev).manual_seed(
                            args.seed + 1))
                    model = model.replace(codebooks=books)
                    summary["kmeans_s"] = time.perf_counter() - t0
                    print(f"Codebooks: residual k-means over "
                          f"{feats.shape[0]} features in "
                          f"{summary['kmeans_s']:.2f} s")
            optimizer = restore_optimizer(
                trainer.make_feature_optimizer(opt, model), model)
            clock[0] = time.perf_counter()
            model, optimizer, logs = trainer.train_features(
                model, cameras, opt, dataset.lf_path, dataset.feature_level,
                iterations=args.iterations, first_iter=first_iter,
                topk=args.topk, use_cos_loss=args.cos_loss,
                use_l1_loss=args.l1_loss, normalize=args.normalize,
                bg_color=bg, seed=args.seed, max_entries=args.max_entries,
                accum_iter=args.accum_iter, cam_batch=args.cam_batch,
                align_iterations=(set(args.checkpoint_iterations)
                                  | set(args.save_iterations)
                                  | set(args.test_iterations)
                                  | {args.iterations}),
                tile_budget=args.tile_budget,
                tile_budget_cap=args.tile_budget_cap,
                tile_budget_subdiv=args.tile_budget_subdiv,
                cull_alpha=args.cull_alpha, optimizer=optimizer,
                feature_cache={}, on_iteration=on_iter_for(phase),
                device=dev)
        else:
            phase = "rgb"
            optimizer = restore_optimizer(trainer.make_rgb_optimizer(
                opt, model, args.accum_iter), model)
            clock[0] = time.perf_counter()
            model, optimizer, logs = trainer.train_rgb(
                model, cameras, opt, scene.cameras_extent,
                iterations=args.iterations, first_iter=first_iter,
                bg_color=bg, white_background=dataset.white_background,
                seed=args.seed, max_entries=args.max_entries,
                accum_iter=args.accum_iter, optimizer=optimizer,
                on_iteration=on_iter_for(phase), device=dev)
        save_outputs(args.iterations, model, optimizer, phase)
    finally:
        metrics_file.close()
        if profiler[0] is not None:
            profiler[0].stop()
    print("\nTraining complete.")
    summary.update(phase=phase, first_iter=first_iter,
                   last_iter=args.iterations, losses=logs.losses,
                   events=logs.events, iteration_ms=iteration_ms,
                   total_entries=total_entries,
                   live_budget=list(logs.live_budget.values()),
                   exp_budget=list(logs.exp_budget.values()))
    return summary


if __name__ == "__main__":
    main()
