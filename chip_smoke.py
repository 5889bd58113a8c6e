#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):
1. environment: GPU name and power limit (nvidia-smi), torch and CUDA;
2. build: nvcc builds the kernels from langsplatv2_tpu_torch/csrc; for
   each instantiation of K2 (csrc/blend.cu) ptxas's registers, stack and
   spill bytes and its occupancy at the main path's width (blocks and
   warps an SM, shared bytes); fails on a spill; the same report for K3
   (csrc/query.cu, f32 and bf16 map, at L = 3, PQ = 5), K6b
   (csrc/gram.cu, M = 64, 128, 192), K4 (csrc/feature_bwd.cu), K7
   (csrc/rgb_bwd.cu), K1 (csrc/expand.cu, every SUBDIV) and K5
   (csrc/feature_bwd_topk.cu, at C = 64, topk 4);
3. kernel checks on a reduced scene (50k Gaussians, 512x512): each CUDA
   kernel against its plain PyTorch version on the card — K1 expansion
   exact, K2 blend (quick and rgb) atol 3e-5, K2 f32 and fast16 on rows
   with NaN / inf xy or conic atol 3e-5, K3 query rtol/atol 1e-5;
   wherever a K2 mode is held against its plain version (phases 3, 5,
   7-16), its pair counts (`stats`) must also equal
   blend.pair_counts_plain on the same inputs;
4. the main path at full width: the bench scene (1M Gaussians, seed 0;
   3 levels x 64 codes x 512-d, top-4 a level = 12 pairs, 192 channels),
   1 positive + 4 negative prompts, render(quick_render=True) +
   relevancy_from_tiles for 5 frames at 1920x1080 and at 986x728, with
   the entry budget sized as bench.py sizes it; launch counters are zeroed
   just before and read just after;
5. at both loads, each kernel on the main path's own inputs held against
   its plain version on the same inputs (tolerances as in phase 3) and
   timed beside it, with its bound for this run's data and (K3) the
   einsum form;
6. training kernels on a reduced scene (50k Gaussians, 272x480): K6a
   (per-tile sums rtol 1e-5 / atol 1e-4), K6b (1e-4 of its largest
   output) and K4 (1e-5 of its largest output) against their plain
   versions on one step's inputs, the fused loss against the plain
   autograd of trainer._gram_cos_core (value rtol 1e-5, gradients 1e-4),
   K6 at M = 192 on random inputs (K6b timed there beside its plain
   version and its bound), and K6b at M = 64, 128, 192 on the segment
   patterns its d_phi treats apart (whole-warp segments with 5% -1 holes,
   a tile of -1 only, 256 distinct ids in a tile; 1e-4 of its largest);
7. the training slice at full width (scripts/profile_train.py's scene:
   300k Gaussians, 544x960, L=1, K=64, top-4, a 512-row GT table, 4
   cameras): train_features for 20 steps with the launch counters zeroed
   just before and read just after; fails unless K1, K2, K4, K6a and K6b
   all launched, the top-k codes kernel launched once a forward (redone
   ones included) and once a backward, the loss is finite and falls, and
   no budget saturates;
   then K4/K6a/K6b on one step's own inputs against their plain versions
   (as in phase 6) and timed beside their bounds, K4 also at C = 192 (a
   seeded cotangent on the same blend), with the step's stages timed
   alone;
8. the geometry step's kernels on a reduced scene (50k Gaussians,
   272x480, SH degree 3), on one step's inputs (the loss's own
   cotangents): K1 exact, K2 rgb-only with bg = 0 (colour and final T,
   atol 3e-5) and K7 (1e-5 of its largest output) against their plain
   versions, and RGBTrainBlend's gradients (K2, K7, index_add_) against
   the chain of plain versions (1e-4 of the largest: atomics);
9. the geometry slice at full width (scripts/profile_rgb_train.py's scene:
   300k Gaussians from create_from_pcd, SH degree 3, 544x960, phase 7's 4
   cameras with seeded images): train_rgb for 24 steps with densification
   at steps 8, 16 and 24 (the first overflows the capacity and grows it),
   the launch counters zeroed just before and read just after; fails
   unless K1, K2 and K7 launched on every step, the loss is finite and
   falls, no entry budget saturates and a densify event grew the live
   count; then, on one step's own inputs of the trained model, the checks
   of phase 8 (K1, K2, K7, the RGBTrainBlend chain), K7 timed beside its
   plain version and its bound, the step's stages timed alone, and the
   opacity reset once on the grown model;
10. the serving default on phase 4's scene and budgets: precision="bf16"
   (fast16 rows), feat_bf16, assemble=False, 5 frames at each load, exact
   and capped (budget 1e-6, cap 128, subdiv 2, as bench.py's capped
   variant), the launch counters zeroed just before and read just after;
   fails unless K1, fast16 K2 and bf16 K3 launched on every frame, every
   output is finite, no entry budget saturates and the capped kept total
   is below the exact live total; prints the relevancy-mask IoU of capped
   against exact (sim > 0.18); then, on each frame's own inputs, fast16 K2
   (outputs before the bf16 rounding atol 3e-5, bf16 outputs within one
   bf16 ulp) and bf16 K3 (rtol/atol 1e-5) against their plain versions,
   timed beside their bounds (K3 also beside the bf16 einsum pair);
11. capped feature training: K5 against its plain version (1e-5 of its
   largest output) on a reduced scene (50k Gaussians, 272x480), then
   train_features with scripts/train.sh's defaults (tile_budget 1e-6,
   cap 128) for 20 steps on phase 7's scene, the launch counters zeroed
   just before and read just after; fails unless K1, K2, K5, K6a and K6b
   launched on every step and K4 never, the loss is finite and falls, and
   the expansion budget was sized from the first step and never
   overflowed; then K5 on one step's own inputs, timed beside its plain
   version and its bound, and the step's stages timed alone;
12. (run after phase 10, on its scene and budgets) the fused-query serving
   frame: rasterize_quick_query + relevancy_from_query, exact and capped,
   5 frames at each load, the launch counters zeroed just before and read
   just after; fails unless K1 and K2q launched on every frame and K2
   (f32 and fast16) and K3 (f32 and bf16) never, every output is finite
   and no entry budget
   saturates; then, on each variant's own inputs, K2q against its plain
   version (rgb and T atol 3e-5, raw and nrm2 1e-5 of their largest) and
   against the unfused routes (f32 tiles + f32 K3: 5e-3 of the largest;
   bf16 tiles + bf16 K3: raw 1e-5, nrm2 5e-3), timed beside its bound and
   the unfused pair (fast16 K2 + bf16 K3); then a torch.profiler trace of
   one 1080p frame of phase 10 (exact) and one fused frame: the device's
   busy share and the five largest kernels;
13. the render server (serve/backend.py) in process at 986x728 on phase
   4's scene, as bench.py:1073-1119 drives it: compose="device", prompt
   "object", budget 1e-6, cap 128, temporal_reuse_px 4, reuse_zref 2, 24
   requests on a yaw path of 1 px a frame after a warm-up, the launch
   counters zeroed just before and read just after; fails unless the
   rebin / steady counters are what the 4 px policy implies, K1 launched
   on every rebin and fast16 K2 on every request (f32 K2, K2q and both
   K3 never), the frames are finite and no budget saturates; then fast16
   K2 on a served steady frame's own inputs (the server's frozen binning
   at the steady request with the most motion, and the same binning after
   a teleport that puts entries behind the near plane) against its plain
   version as phase 10 holds it; times (host clock) the steady and rebin
   requests, a pose-cache hit, a capped request without reuse, an rgb
   request, the bin-cache build and a fused steady frame; the steady frame
   at its bin pose must equal a fresh capped render with cov3d_precomp
   (kept equal, rgb atol 1e-6); prints the relevancy error and mask IoU of
   fused steady frames against fresh fused frames at 1-16 px, and holds
   K2q against its plain version on one of them.
14. dense features (K2's dense mode, the dense VJP): (a) on a reduced
   scene (50k Gaussians, 272x480) K2 dense against its plain version at
   D = 64, 192 and 256 (two channel groups), atol 3e-5, and K4 at C = 192
   (1e-5 of its largest); (b) on phase 7's training scene,
   get_render_weights(4) -> rasterize(features=..., impl="pallas") and the
   backward of <map, seeded cotangent> for 20 steps, the launch counters
   zeroed just before and read just after (K1, K2 dense and K4 on every
   step), d(features) on each Gaussian's top-4 against the quick_train
   route's d(quick_weights) (1e-5 of the largest), K2 dense and K4 on one
   step's inputs timed beside their bounds; (c) on phase 4's scene at both
   loads, the dense map of the scattered quick pairs (D = 192) against the
   f32 quick frame (1e-5), K2 dense timed;
15. bf16 cell math on phase 10's scene and budgets: phases 10's and 12's
   frames with bf16_cells at both loads, exact and capped, 5 each, counted
   (K1, fast16 K2, K2q, bf16 K3 on every frame); relevancy mask IoU >= 0.95
   against the f32-cell frames; fast16 K2 and K2q with bf16 cells against
   their plain versions on each frame's own inputs at the fast16 contract
   (phase 10's and 12's limits), and each output of the cells further from
   the f32 cells' than ten times that limit, timed; phase 13's requests
   through BackendRenderer(bf16_cells=True);
16. the cascade binner: K8 on a reduced scene (phase 3's) against its plain
   version and the sort binning's segments (equal); at both loads of phase
   4's scene, 5 cascade frames each, counted (K8, K2 and K3 on every frame,
   K1 never), each equal to phase 4's frame bit for bit, their CUDA-event
   stages printed beside phase 4's f32 frame's, K8 against its plain
   version and the sort segments (equal) and timed beside the sort stage
   (K1 + key sort), its device operations besides the depth sort's at most
   cascade.LAUNCHES, K2 on its segments timed, and an overflow probe
   (budget half the kept total: the flag set, the total within it);
17. the round-4 capped chain (scripts/profile_capped_stages.py:10-13) on
   phase 4's scene and budgets, budget 1e-6, cap 128, subdiv 2: the
   preprocess, K1 with_alpha, pack_lm_words, the sort carrying the word,
   slice_windows, budget_counts_windowed, fast16 K2 on the kept counts, bf16
   K3 and the relevancy tail, 5 frames at each load, counted (K1 with_alpha,
   fast16 K2, bf16 K3 on every frame); K1 with_alpha against its plain
   version (entries equal, lm within 2 f32 ulps, words equal) and timed
   beside plain K1 and its bound; the windowed counts equal to
   min(budget_counts, cap) on every tile; printed: kept against
   budget_from_rows' (the share of equal tiles, the largest difference)
   and the relevancy IoU against the exact bf16 frame beside phase 10's;
18. K9, the cell-chain probe, on [512, 256, 256] in f32 and bf16, counted,
   each against its plain version (f32 1e-5 of the largest, bf16 2 bf16
   ulps of the largest, no element different), timed: G chains/s,
   bf16_over_f32_rate, each form's bound as the largest of five floors
   (bytes, MUFU, FP32 lanes, packed lanes, issue slots) with its basis, the
   pairs whose bf16 chain ran again with expf, the SASS instructions a
   chain by unit (static, and on the bf16 form's common path, probe.cu
   built once more with -DLSV2_PROBE_HOT_PATH), and the ex2.approx.bf16x2
   what-if (not K9's arithmetic);
19. the eval drivers: the golden fixture (tests/golden/eval_golden.npz)
   through the port on the card at atol 1e-5; evaluate_quick (hash CLIP
   backend, Gram relevancy) on 4 annotated frames at 986x728, 4 prompts a
   frame, GT from a seed, on the bench scene at the largest of 1M / 750k /
   500k Gaussians whose frames all stay below make_settings' 2**21 entries
   (fails if none does), counted (K1, K2, K3 on every frame) and timed a
   frame (render + relevancy, segmentation, localization); LPIPS (VGG,
   random weights) and evaluate_psnr on one frame, timed; evaluate (three
   level models) against evaluate_quick (their merge) on a reduced scene
   (50k Gaussians, 512x512): levels and localization equal, mean IoU
   within 1e-4;
20. the shapes past the main path's kernel designs: a 1080p frame with 13
   positives (PQ = 17 a level) in f32, bf16 and fused, counted, K3, bf16
   K3 and K2q on its inputs against their plain versions and timed; 4
   feature steps at codebook_size 32 (K6a, K6b, K4 on a step's inputs);
   K6a and K6b at M = 256; and K1 on the edge shapes only the card runs
   at scale (`wide_expand_case`: rects over all 8,160 tiles of a 1080p
   grid among runs of zero-tile Gaussians, max_entries past the total,
   cutting a whole-grid rect mid-rect and on a block edge), both modes
   against the plain version (entries equal, with_alpha 2's lm within 2
   f32 ulps, words equal), timed;
21. training from a scene directory: a COLMAP scene written to
   build/chip_smoke_scene (scripts/profile_train.py's 300,000 points and
   colours, 8 PINHOLE cameras on a yaw arc at 544x960, seeded PNG images,
   phase 7's GT files) trained in process through
   langsplatv2_tpu_torch.train.cli's main with the default device: the
   geometry phase (24 iterations, accum_iter 2), feature phases from its
   checkpoint with the k-means codebooks (--cos_loss --topk 4): 24
   iterations, 24 at cam_batch 4, 16 at cam_batch 4 capped (budget
   1e-6), 8 in pixel space (l1, normalize, accum_iter 2), and a resume of
   the cam_batch run for 4 more; each run's launch counts (zeroed just
   before, read just after; the kernels of its route above 0, the others
   0), finite losses that fall over 8 cameras (runs of 16 iterations or
   more), no expansion at max_entries, step times, scene load and k-means
   times, no fresh moments on the resume; then the trained model saved as
   a reference .pth and read back, its quick frame bit-equal to the .npz
   model's, the checkpoints' save and load times;
22. the command lines a user runs on a trained scene, in process: phase
   19's three level models (at its size) as .npz checkpoints, its 4
   cameras as a COLMAP scene (986x728) with labelme GT (its rectangles as
   polygons, each filled to exactly its block, and a concave polygon a
   frame) and PNG mask folders; eval_lerf (quick: equal to
   evaluate_quick called directly at 1e-6; --no-quick within 1e-4 of it,
   localization equal), eval_3d_ovs and eval_mip_nerf360 (finite), each
   counted (K1, K2 and, on the Gram route, K3 once a frame and a level
   model; nothing else) and its drivers timed a frame; eval_psnr on phase
   21's geometry checkpoint (--iteration -1) equal to evaluate_psnr; the
   render server built by serve/backend_renderer.py from the checkpoints,
   5 requests equal to a server built on the merged model (K1 and fast16
   K2 once a request), timed; the training command line with --gui
   (--port 0) resuming phase 21's geometry checkpoint for 3 iterations,
   a SIBR client thread asking for a frame with the Python SH colours and
   covariances (scaling_modifier 0.8), one without, then training on:
   each frame within one u8 level of a direct render of the checkpoint,
   the verify string the source path; the frame without the Python
   covariances launches K1 and K2 once, the one with them takes the XLA
   route, as JAX's viewer does: K1 without the cull once, no K2;
23. the XLA route (impl="xla", JAX's differentiable pipeline): (a) K1
   without the exact cull on phase 4's scene at 1080p (the route's 3-sigma
   rects) against its plain version bit for bit at a budget above the
   total and one cutting it, timed beside K1 with the cull and
   bin_gaussians; (b) the geometry step through impl="xla" on phase 9's
   scene (300k, SH 3, 544x960) at tile_cap 512, tile_batch 16, 20 steps
   counted (K1 without the cull each step, nothing else): the median
   step, its forward and backward, the peak memory, a falling finite loss,
   finite gradients; (c) on a reduced scene (3,000 Gaussians, 160x128,
   every tile within tile_cap) the route against the per-pixel oracle
   on the card (images atol 1e-5, every gradient 2e-5 of the largest) and
   against the kernel routes (RGB with K7, dense with K2 dense, quick at
   192 channels with K2 f32 and K4: images atol 3e-5, their gradients 2e-5
   of the largest); (d) dense features (64) with geometry gradients under
   impl="auto" on phase 7's scene, one step timed with its peak memory,
   and an RGB frame on binning="cascade" under "auto" equal to the
   impl="xla" frame bit for bit; (e) train.cli --impl xla --tile_cap 512
   on phase 21's scene, 8 geometry and 8 feature iterations, counted, ms
   a camera beside phase 21's; (f) the render tools (demo_prompt,
   debug_renderer) on phase 22's checkpoints and scene, their files and
   arrays equal to direct renders, counted;
24. preprocessing a scene (no kernel on this path): (a) SAM at VIT_H width
   (random N(0, 0.02) weights from a seeded generator) encodes one 1024^2
   input, median ms of 3 after a warm-up with TF32 off and on, peak
   memory; the same modules at VIT_TINY_TEST on the card against the CPU
   (1e-4 of the largest); (b) the automatic generator on a synthetic
   1080x1440 image (32x32 points, 64 a batch, the thresholds open as
   tests/test_sam_jax.py opens them: random weights pass none), decode ms
   a batch, generate s, masks a level before and after the box NMS; (c)
   masks_update on its levels, the intersection product of 256 candidate
   masks timed, 64 random pairs equal to the int64 sums of logical_and;
   (d) the pipeline on 3 images with the hash CLIP backend, read back by
   Camera.get_language_feature_compact; (e) the cluster segmenter at
   1080x1440, s an image, twice with the same masks; (f) preprocess.cli
   --mask_backend cluster on 2 images, its files equal to the in-process
   pipeline's;
25. distribution (K2 and K4 gain a first-tile offset; no new kernel): (a)
   on a reduced scene (50k, 512x512) K2 f32 quick and rgb and K4 on two
   strips from tile_base > 0, one running past the grid, against their
   plain versions (K2 atol 3e-5 and its pair counts, K4 1e-5 of the
   largest) and bit-equal to the whole-grid launch's slots; (b) phase 4's
   1M-Gaussian 1080p frame sharded over 4 gloo ranks that share the card
   (parallel.spawn_ranks, a file:// store; the exchange staged through
   the host), each rank holding its rows, at a pair capacity of the local
   budget: 2 frames counted and timed, each strip against the single-card
   sort route (atol 2e-5), dropped 0, totals and radii equal, >= 1e4
   entries exchanged, no rank's K1 budget saturated, K2 timed on rank 0's
   received strip beside its plain version; then a capacity below the
   largest pair's load: dropped > 0 and equal to the host recount from
   every rank's segment lengths; (c) phase 7's scene (300k, 544x960, K =
   64, top-4) sharded: d(quick_weights) through the reverse all-to-all
   against the single-card QuickTrainBlend gradient (1e-4 of the largest),
   K4 timed on rank 0's strip; (d) at phase 23's XLA scale (300k,
   544x960, tile_cap 512) rasterize_sharded on (1, 4), the Gram loss,
   its gradients and a feature step, the geometry loss, its gradients and
   the carrier's and a geometry step with the batch's densify statistics
   on (2, 2), against the single-card XLA route (images atol 1e-5, radii
   exact, losses rtol 1e-5, gradients 5e-4 of the largest); (e)
   save_checkpoint_multihost from the 4-rank world, written by rank 0
   alone and loaded on one card equal to the model; (f) (b)'s frame in a
   world of one rank over NCCL, bit-equal to the gloo ranks' strips.
   Times are host-staged where gloo carries the data. A part alone:
   import chip_smoke and call `distribution_path(torch.device("cuda"),
   smi)` after `kernels.build()`;
26. the preprocess kernel (csrc/preprocess.cu; it replaces no Pallas
   kernel): phase 4's scene with seeded SH degree 3 rows at 1080p, every
   field bit for bit against its plain version, both timed with the
   kernel's bound, registers, spills (a spill fails) and occupancy, the
   torch.cat of the SH rows it no longer needs timed, each call's host
   time; a served frame counts one launch and no plain call; the frame,
   the kernel with the camera as numpy arrays and the parent's pageable
   camera copy under torch.cuda.set_sync_debug_mode("error") (the kernel
   path must not synchronise). A part alone: import chip_smoke and call
   `preprocess_kernel_path(torch.device("cuda"))` after `kernels.build()`;
27. the top-k codes kernel (csrc/topk_codes.cu; it replaces no Pallas
   kernel) at [1M, 64] logits, top 4: indices bit for bit and weights
   within 2 float32 steps against the plain path, its backward within 1e-6
   of autograd's through the plain path and exactly 0 outside the
   selection; the device ms of both directions beside the kernel's byte
   bounds (and portbench/roofline.py's), the plain path's and torch.topk
   + sort + gather + softmax's; registers, spills (a spill fails), occupancy; a step's
   codes count one launch forward and one backward and synchronise
   nothing. A part alone: import chip_smoke and call
   `topk_codes_path(torch.device("cuda"))` after `kernels.build()`;
28. the preprocess under autograd (projection.PreprocessGrad: the forward
   kernel and csrc/preprocess_bwd.cu; it replaces no Pallas kernel) on
   the geometry cell's own inputs (portbench's lerf_rgb_1m scene, 1M live
   Gaussians in 1,250,048 slots, SH 3, 960x544): the forward bit for bit
   against preprocess_plain under autograd; a geometry step's own
   cotangents through the backward kernel against the plain adjoint and
   autograd through the plain path (1e-5 of each leaf's largest); the
   device ms of the backward kernel beside its bounds (and
   portbench/roofline_geometry.py's), of the forward kernel, the plain
   adjoint and autograd's backward through the plain path (the parent's
   route), with their device operations; registers, spills (a spill
   fails), occupancy; a step counts one forward and one backward launch
   and no plain call, and its device operations on both routes. A part
   alone: import chip_smoke and call `preprocess_grad_path(
   torch.device("cuda"))` after `kernels.build()`.
It prints the kernels line (max_abs_err: for K1 and K2 the largest of
phases 3, 5, 8 and 9; for K4 and K6 of phases 6, 7 and (K4) 14; for K7 of
phases 8 and 9; for fast16 K2 of phases 3 (non-finite rows), 10 and 13, for
bf16 K3 of phase 10, for K5 of phase 11, for K2q of phases 12 and 13; for
K2 dense of phase 14, for the bf16-cell modes of phase 15, for K8 (entries
that differ, 0) and K2 on its segments of phase 16, for K1 with_alpha of
phase 17 at both loads, for K9 of phase 18, for K1 without the cull of
phase 23 (a), its launches from (b); for K2 and K4 on a received strip
of phase 25 (a), (b) and (c), their launches summed over the ranks; for
the preprocess of phase 26; for the top-k codes of phase 27, the weights'
and d(logits)' largest differences, its launches from phase 7's training
run; for the preprocess's backward of phase 28, the kernel's largest
difference from the plain adjoint, its launches a geometry step) and,
last,
{"ok": true, "device": {...}}.
Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from langsplatv2_tpu_torch import tracing
from langsplatv2_tpu_torch.eval import lerf, psnr_eval
from langsplatv2_tpu_torch.eval import lpips as lpips_mod
from langsplatv2_tpu_torch.eval.openclip import OpenCLIPNetwork
from langsplatv2_tpu_torch.models.gaussians import (create_from_pcd,
                                                    from_numpy_params,
                                                    init_language_features)
from langsplatv2_tpu_torch.models.renderer import make_settings, render
from langsplatv2_tpu_torch.ops import (binning, blend, budget, cascade,
                                       expand, gram, kernels, probe,
                                       projection, query, rasterize_tiles,
                                       rgb_train, temporal, train)
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings, \
    capped_binning, mark_stage, rasterize, rasterize_quick_query, \
    sorted_binning
from langsplatv2_tpu_torch.ops.rasterize_reference import \
    rasterize_reference
from langsplatv2_tpu_torch.serve.backend import BackendRenderer
from langsplatv2_tpu_torch.scene.cameras import Camera
from langsplatv2_tpu_torch.train import trainer
from langsplatv2_tpu_torch.train.config import OptimizationParams
from langsplatv2_tpu_torch.ops import topk_codes
from langsplatv2_tpu_torch.utils import losses, sparse_codes
from langsplatv2_tpu_torch.utils.camera_math import (get_projection_matrix,
                                                     get_world_to_view)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 rate, f32 rate outside
# the tensor cores, and f32-accurate tensor-core products (3xTF32: a third
# of the 495 TFLOP/s TF32 rate), the floor for K3's matrix products.
# Rates assume the 700 W limit; the card's limit is printed.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F32_TENSOR_FLOPS = 495e12 / 3
BF16_TENSOR_FLOPS = 989e12
L, K, TOPK, DIM = 3, 64, 4, 512
PROMPTS = ["teddy bear"]              # + the 4 canonical negatives
LOADS = [("1080p", 1080, 1920, 5_300_000), ("986x728", 728, 986, 3_900_000)]
FRAMES = 5
# f32 operations per (entry, pixel) pair in K2: the alpha test (dx, dy,
# the conic quadratic, exp, scale, clamp), and for an included pair the
# transmittance step plus rgb and top-k accumulates (2 each).
BLEND_ALPHA_FLOPS = 14
BLEND_INCLUDE_FLOPS = 3 + 2 * (3 + L * TOPK)
CULL_FLOPS = 60                       # K1's exact cull per entry
KERNELS = {
    "K1": ("expand_entries", "langsplatv2_tpu_torch/csrc/expand.cu",
           "langsplatv2_tpu/ops/pallas_binning.py:498"),
    "K2": ("blend_tiles", "langsplatv2_tpu_torch/csrc/blend.cu",
           "langsplatv2_tpu/ops/pallas_blend.py:695"),
    "K3": ("query_map_tiles", "langsplatv2_tpu_torch/csrc/query.cu",
           "langsplatv2_tpu/ops/pallas_query.py:92"),
    "K4": ("feature_grads", "langsplatv2_tpu_torch/csrc/feature_bwd.cu",
           "langsplatv2_tpu/ops/pallas_train.py:241"),
    "K6a": ("gram_tiles_fwd", "langsplatv2_tpu_torch/csrc/gram.cu",
            "langsplatv2_tpu/ops/pallas_gram.py:175"),
    "K6b": ("gram_tiles_bwd", "langsplatv2_tpu_torch/csrc/gram.cu",
            "langsplatv2_tpu/ops/pallas_gram.py:205"),
    "K7": ("rgb_grads", "langsplatv2_tpu_torch/csrc/rgb_bwd.cu",
           "langsplatv2_tpu/ops/pallas_rgb_train.py:290"),
    "K5": ("feature_grads_topk", "langsplatv2_tpu_torch/csrc/feature_bwd_topk.cu",
           "langsplatv2_tpu/ops/pallas_train.py:449"),
    "K2f16": ("blend_tiles_fast16", "langsplatv2_tpu_torch/csrc/blend.cu",
              "langsplatv2_tpu/ops/pallas_blend.py:695"),
    "K3bf16": ("query_map_tiles_bf16", "langsplatv2_tpu_torch/csrc/query.cu",
               "langsplatv2_tpu/ops/pallas_query.py:92"),
    "K2q": ("blend_tiles_query", "langsplatv2_tpu_torch/csrc/blend.cu",
            "langsplatv2_tpu/ops/pallas_blend.py:695"),
    "K2dense": ("blend_tiles_dense", "langsplatv2_tpu_torch/csrc/blend.cu",
                "langsplatv2_tpu/ops/pallas_blend.py:695"),
    "K2f16cells": ("blend_tiles_fast16[bf16_cells]",
                   "langsplatv2_tpu_torch/csrc/blend.cu",
                   "langsplatv2_tpu/ops/pallas_blend.py:695"),
    "K2qcells": ("blend_tiles_query[bf16_cells]",
                 "langsplatv2_tpu_torch/csrc/blend.cu",
                 "langsplatv2_tpu/ops/pallas_blend.py:695"),
    "K8": ("cascade_binning", "langsplatv2_tpu_torch/csrc/cascade.cu",
           "langsplatv2_tpu/ops/pallas_cascade.py:376"),
    "K2comb": ("blend_tiles[cascade segments]",
               "langsplatv2_tpu_torch/csrc/blend.cu",
               "langsplatv2_tpu/ops/pallas_blend.py:695"),
    "PRE": ("preprocess", "langsplatv2_tpu_torch/csrc/preprocess.cu",
            "none: langsplatv2_tpu/ops/projection.py is XLA code"),
    "TOPK": ("topk_codes", "langsplatv2_tpu_torch/csrc/topk_codes.cu",
             "none: langsplatv2_tpu/utils/sparse_codes.py is XLA code"),
    "PREB": ("preprocess_grads",
             "langsplatv2_tpu_torch/csrc/preprocess_bwd.cu",
             "none: jax.vjp of langsplatv2_tpu/ops/projection.py (XLA code)"),
    "K1_with_alpha": ("expand_entries[with_alpha]",
                      "langsplatv2_tpu_torch/csrc/expand.cu",
                      "langsplatv2_tpu/ops/pallas_binning.py:498"),
    "K9f32": ("cell_chain[f32]", "langsplatv2_tpu_torch/csrc/probe.cu",
              "scripts/profile_vpu_bf16.py:53"),
    "K9bf16": ("cell_chain[bf16]", "langsplatv2_tpu_torch/csrc/probe.cu",
               "scripts/profile_vpu_bf16.py:53"),
    "K3pq17": ("query_map_tiles[PQ=17]", "langsplatv2_tpu_torch/csrc/query.cu",
               "langsplatv2_tpu/ops/pallas_query.py:92"),
    "K3bf16pq17": ("query_map_tiles_bf16[PQ=17]",
                   "langsplatv2_tpu_torch/csrc/query.cu",
                   "langsplatv2_tpu/ops/pallas_query.py:92"),
    "K2qpq17": ("blend_tiles_query[PQ=17]",
                "langsplatv2_tpu_torch/csrc/blend.cu",
                "langsplatv2_tpu/ops/pallas_blend.py:695"),
    "K6aK32": ("gram_tiles_fwd[K=32]", "langsplatv2_tpu_torch/csrc/gram.cu",
               "langsplatv2_tpu/ops/pallas_gram.py:175"),
    "K6bK32": ("gram_tiles_bwd[K=32]", "langsplatv2_tpu_torch/csrc/gram.cu",
               "langsplatv2_tpu/ops/pallas_gram.py:205"),
    "K1nocull": ("expand_entries[exact_cull=False]",
                 "langsplatv2_tpu_torch/csrc/expand.cu",
                 "langsplatv2_tpu/ops/pallas_binning.py:498"),
    "K2strip": ("blend_tiles[tile_base, received strip]",
                "langsplatv2_tpu_torch/csrc/blend.cu",
                "langsplatv2_tpu/ops/pallas_blend.py:695"),
    "K4strip": ("feature_grads[tile_base, received strip]",
                "langsplatv2_tpu_torch/csrc/feature_bwd.cu",
                "langsplatv2_tpu/ops/pallas_train.py:241"),
}
WRAPPERS = {"K1": "k1.launches", "K2": blend.blend_tiles,
            "K3": query.query_map_tiles}
TRAIN_WRAPPERS = {"K1": "k1.launches", "K2": blend.blend_tiles,
                  "K4": train.feature_grads, "K6a": gram.gram_tiles_fwd,
                  "K6b": gram.gram_tiles_bwd, "TOPK": "topk_codes.launches"}
# The training slice (scripts/profile_train.py's scene): 300k Gaussians at
# 544x960, one level of 64 codes, top-4, a 512-row GT table.
TRAIN_N, TRAIN_H, TRAIN_W, TRAIN_K, TRAIN_TOPK, TRAIN_S = (
    300_000, 544, 960, 64, 4, 512)
TRAIN_ITERS = 20
TRAIN_YAW_DEG = (-6.0, -2.0, 2.0, 6.0)    # 4 cameras around the scene
GT_DIR = os.path.join("build", "chip_smoke_gt")
# The geometry slice (scripts/profile_rgb_train.py's scene): 24 steps with
# densification at steps 8, 16 and 24.
RGB_WRAPPERS = {"K1": "k1.launches", "K2": blend.blend_tiles,
                "K7": rgb_train.rgb_grads}
RGB_N, RGB_ITERS, RGB_EXTENT = 300_000, 24, 5.0
RGB_DENSIFY = dict(densify_from_iter=4, densification_interval=8,
                   densify_until_iter=25)
# f32 operations of K7 for an included (entry, pixel) pair beyond the
# alpha test: c.g (5), w and the prefix (3), 1 / (1 - alpha) (2), d_alpha
# (5), the chain to d(x, y, conic, op) (15), d(rgb) (3), and the 9 adds
# that sum the pair into its entry's row.
RGB_BWD_INCLUDE_FLOPS = 42
# The serving default's rows (phase 10) and the capped routes: bench.py's
# capped variant and scripts/train.sh's training defaults.
BF16_WRAPPERS = {"K1": "k1.launches",
                 "K2f16": blend.blend_tiles_fast16,
                 "K3bf16": query.query_map_tiles_bf16}
CAPPED = dict(tile_budget=1e-6, cap=128, subdiv=2)
CAPPED_WRAPPERS = {"K1": "k1.launches", "K2": blend.blend_tiles,
                   "K4": train.feature_grads, "K5": train.feature_grads_topk,
                   "K6a": gram.gram_tiles_fwd, "K6b": gram.gram_tiles_bwd}
# Phases 12-13: the fused-query frame and the render server. Every serving
# wrapper is counted, so that the runs show which ones did not launch.
SERVE_WRAPPERS = {"K1": "k1.launches", "K2": blend.blend_tiles,
                  "K2f16": blend.blend_tiles_fast16,
                  "K2q": blend.blend_tiles_query,
                  "K3": query.query_map_tiles,
                  "K3bf16": query.query_map_tiles_bf16}
# Phases 14-16: dense features, bf16 cell math, the cascade binner.
DENSE_WRAPPERS = {"K1": "k1.launches",
                  "K2dense": blend.blend_tiles_dense,
                  "K4": train.feature_grads}
DENSE_WIDTHS = (64, 192, 256)          # 256: two channel groups
CELLS_WRAPPERS = {"K1": "k1.launches",
                  "K2f16": blend.blend_tiles_fast16,
                  "K2q": blend.blend_tiles_query,
                  "K3bf16": query.query_map_tiles_bf16}
# bf16 cells: the map (K2q: the scores, of their largest) must differ
# from the f32 cells' by more than this many times the kernel-vs-plain
# limit, or the kernel did not run the cell math.
CELLS_EFFECT = 10.0
CASCADE_WRAPPERS = {"K1": "k1.launches",
                    "K8": cascade.cascade_binning, "K2": blend.blend_tiles,
                    "K3": query.query_map_tiles}
# Phase 20: the shapes past the main path's kernel designs: 13 positives a
# frame (PQ = 17 a level), feature steps at codebook_size 32, the Gram loss
# at M = 256.
MANY_POSITIVES = [f"part {i}" for i in range(13)]
MANY_PQ = len(MANY_POSITIVES) + 4
MANY_PQ_WRAPPERS = {"K3": query.query_map_tiles,
               "K3bf16": query.query_map_tiles_bf16,
               "K2q": blend.blend_tiles_query}
SMALL_K, SMALL_K_ITERS = 32, 4
SMALL_K_WRAPPERS = {"K6a": gram.gram_tiles_fwd, "K6b": gram.gram_tiles_bwd}
# Phase 21: training from a scene directory through the CLI, at phase 7's
# width (300,000 points, 544x960, L = 1, K = 64, top-4) with 8 cameras on
# a yaw arc. create_from_pcd's 3-NN scales make the Gaussians wider than
# phase 7's, hence the larger entry budget.
SCENE_WRAPPERS = {"K1": "k1.launches", "K2": blend.blend_tiles,
                  "K4": train.feature_grads, "K5": train.feature_grads_topk,
                  "K6a": gram.gram_tiles_fwd, "K6b": gram.gram_tiles_bwd,
                  "K7": rgb_train.rgb_grads}
SCENE_YAW_DEG = tuple(-7.0 + 2.0 * i for i in range(8))
SCENE_MAX_ENTRIES = 2 ** 23
SERVE_LOAD = "986x728"                 # the server's load (bench.py:1013)
SERVE_REQUESTS = 24
REUSE_PX = 4.0


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _counter(w):
    """A wrapper's launch counter: the function (its `launches`) or
    (function, attribute name); a str names a counter of tracing.py."""
    return w if isinstance(w, tuple) else (w, "launches")


# The registry's values at the last zero_counts: its counters are read as
# the growth since then.
_REGISTRY_ZERO: dict = {}


def zero_counts(wrappers) -> None:
    torch.cuda.synchronize()
    now = tracing.counters()
    for w in wrappers.values():
        if isinstance(w, str):
            _REGISTRY_ZERO[w] = now.get(w, 0)
        else:
            setattr(*_counter(w), 0)


def read_counts(wrappers) -> dict:
    torch.cuda.synchronize()
    now = tracing.counters()
    return {k: now.get(w, 0) - _REGISTRY_ZERO.get(w, 0)
            if isinstance(w, str) else getattr(*_counter(w))
            for k, w in wrappers.items()}


def bench_scene(n: int, seed: int = 0) -> dict:
    """bench.py:238-251 (same draws in the same order), as GaussianModel
    fields: SH degree 0 colour, log-scale, logit opacity."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.uniform(-4, 4, (n, 2)),
                            rng.uniform(2.0, 12.0, (n, 1))], 1).astype(np.float32)
    scales = rng.uniform(0.004, 0.04, (n, 3)).astype(np.float32)
    rotations = rng.normal(size=(n, 4)).astype(np.float32)
    opacities = rng.uniform(0.2, 0.95, (n, 1)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    qw = rng.uniform(0, 1, (n, L * TOPK)).astype(np.float32)
    qw /= qw.sum(1, keepdims=True)
    qi = np.concatenate([rng.integers(0, K, (n, TOPK)) + lvl * K
                         for lvl in range(L)], axis=1).astype(np.float32)
    codebooks = rng.normal(size=(L, K, DIM)).astype(np.float32)
    return dict(
        xyz=means, scaling=np.log(scales), rotation=rotations,
        opacity=np.log(opacities / (1 - opacities)),
        features_dc=((colors - 0.5) / 0.28209479177387814)[:, None, :],
        features_rest=np.zeros((n, 0, 3), np.float32),
        quick_weights=qw, quick_indices=qi, codebooks=codebooks)


def bench_camera(h: int, w: int):
    fovy = math.radians(60)
    fovx = 2 * math.atan(math.tan(fovy / 2) * w / h)
    w2c = get_world_to_view(np.eye(3), np.zeros(3))
    view = np.asarray(w2c.T, np.float32)
    proj = np.asarray(w2c.T @ get_projection_matrix(0.01, 100, fovx, fovy).T,
                      np.float32)
    return view, proj, math.tan(fovx / 2), math.tan(fovy / 2)


def cuda_ms(fn, reps: int):
    """(mean device time of fn() over reps launches after one warm-up
    call, the warm-up call's result)."""
    out = fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound(nbytes: float, flops: float,
          rate: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def stage_inputs(model, settings, view, pm, clip_consts, dev):
    """The inputs each kernel gets on the main path (same calls as
    rasterize), for timing the kernels alone."""
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    op = model.get_opacity()[:, 0].contiguous()
    proj = projection.preprocess(
        model.xyz, model.get_scaling(), model.get_rotation(),
        model.get_features(), None, T(view), T(pm), torch.zeros(3, device=dev),
        settings.tanfovx, settings.tanfovy, settings.image_width,
        settings.image_height, 0, opacities=op)
    g, start, count, total, live = sorted_binning(settings, proj, op)
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, op, proj.rgb)
    return dict(proj=proj, op=op, g=g, start=start, count=count,
                total=int(total), live=int(live), geom=geom,
                bg=torch.zeros(3, device=dev),
                qw=model.quick_weights.contiguous(),
                qi=model.quick_indices.contiguous(),
                phi=clip_consts[0], gram=clip_consts[1])


# K2's instantiations (csrc/blend.cu's template arguments kFast16, kQuery,
# kCells, kDense, kOwn, the threads a pixel, and kQA, the fused query's
# design), the kernels line's rows that run each, and the width of the
# main path's launches (rgb: the geometry step's forward, and dense at D =
# 192, phase 14's map: no row of their own; the fused query at any shape:
# phase 20's 13 positives at 3 x 64, and 8 x 32 = 256 channels, two blocks
# a tile).
K2_MODES = {(0, 0, 0, 0, 3, 0): ("f32", ("K2", "K2comb", "K2strip"), L * K,
                                  L * TOPK),
            (0, 0, 0, 0, 1, 0): ("rgb", (), 0, 0),
            (1, 0, 0, 0, 3, 0): ("fast16", ("K2f16",), L * K, L * TOPK),
            (1, 0, 1, 0, 3, 0): ("fast16 cells", ("K2f16cells",), L * K,
                                 L * TOPK),
            (1, 1, 0, 0, 3, 0): ("query", ("K2q",), L * K, L * TOPK),
            (1, 1, 1, 0, 3, 0): ("query cells", ("K2qcells",), L * K,
                                 L * TOPK),
            (0, 0, 0, 1, 3, 0): ("dense", (), L * K, 0),
            (0, 0, 0, 1, 1, 0): ("dense narrow", ("K2dense",), TRAIN_K, 0),
            (1, 1, 0, 0, 3, 1): ("query any", ("K2qpq17",), L * K, L * TOPK),
            (1, 1, 1, 0, 3, 1): ("query any cells", (), L * K, L * TOPK),
            (1, 1, 0, 0, 3, 2): ("query pair", (), 256, 8),
            (1, 1, 1, 0, 3, 2): ("query pair cells", (), 256, 8)}


def k2_build_report() -> dict:
    """Phase 2: ptxas's line for each K2 instantiation (registers, stack,
    spill bytes) and its occupancy at the main path's width (blocks and
    warps an SM, shared bytes); fails on a spill or a missing
    instantiation."""
    rep = {}
    for r in kernels.ptxas_report("blend.cu"):
        m = re.search(r"blend_kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)ELi(\d)"
                      r"ELi(\d)E", r["name"])
        if m is None:
            continue
        mode, rows, width, topk = K2_MODES[tuple(int(v) for v in m.groups())]
        occ = blend.kernel_occupancy(mode, width, topk)
        rep[mode] = dict(ptxas=r, occupancy=occ, rows=rows)
        log(f"K2 {mode}: ptxas: {r['line']}; {r['stack']} bytes stack "
            f"frame, {r['spill_stores']} bytes spill stores, "
            f"{r['spill_loads']} bytes spill loads; at C = {width}: "
            f"{occ['blocks_per_sm']} block(s) of {occ['threads']} threads, "
            f"{occ['warps_per_sm']} warps an SM, {occ['smem_bytes']} bytes "
            f"of shared memory, {occ['local_bytes']} local bytes")
    if len(rep) != len(K2_MODES) or any(
            v["ptxas"]["spill_stores"] or v["ptxas"]["spill_loads"]
            or v["occupancy"]["blocks_per_sm"] < 1 for v in rep.values()):
        fail(f"K2: an instantiation is missing, spills or does not fit: "
             f"{rep}")
    return rep


# The main path's prompts a level: 1 positive and the 4 canonical negatives.
MAIN_PQ = len(PROMPTS) + 4


def qg_build_report() -> dict:
    """Phase 2: ptxas's line (registers, stack, spill bytes) for K3 (f32
    and bf16 map, the main path's design at L = 3, PQ = 5 and the general
    one), every instantiation of K6a and K6b (csrc/gram.cu: k-panels of the
    stage, 0 unstaged; compile-time or run-time widths), K4 and K7 and each
    one's occupancy, K5 (at C = 64, topk 4) and K1 (every SUBDIV); fails
    on a missing instantiation, a spill or one that does not fit."""
    want = {"K3 f32": ("query_kernelILb0E",
                       lambda: query.kernel_occupancy(False, L, MAIN_PQ)),
            "K3 bf16": ("query_kernelILb1E",
                        lambda: query.kernel_occupancy(True, L, MAIN_PQ)),
            "K3 any f32": ("query_any_kernelILb0E",
                           lambda: query.kernel_occupancy(False, L,
                                                          MANY_PQ)),
            "K3 any bf16": ("query_any_kernelILb1E",
                            lambda: query.kernel_occupancy(True, L,
                                                           MANY_PQ))}
    for bwd in (0, 1):
        for run_time in (0, 1):
            for kpk in range(1 - run_time, gram.STAGE_PANELS + 1):
                label = (f"{('K6a', 'K6b')[bwd]} kpk={kpk}"
                         + (" any" if run_time else ""))
                want[label] = (
                    f"gram_kernelILi{kpk}ELb{bwd}ELb{run_time}E",
                    lambda a=(bwd, kpk, run_time): kernels.occupancy(
                        "lsv2_gram_occupancy", *a))
    want["K4"] = ("feature_bwd_kernel", lambda: kernels.occupancy(
        "lsv2_feature_bwd_occupancy"))
    want["K7"] = ("rgb_bwd_kernel", lambda: kernels.occupancy(
        "lsv2_rgb_bwd_occupancy"))
    want["K5"] = ("feature_bwd_topk_kernel", lambda: kernels.occupancy(
        "lsv2_feature_bwd_topk_occupancy", TRAIN_K, TRAIN_TOPK))
    for sub in (0, 1, 2, 4, 8, 16):
        want[f"K1 s={sub}"] = (f"expand_kernelILi{sub}E",
                               lambda a=sub: kernels.occupancy(
                                   "lsv2_expand_occupancy", a))
    found = [r for src in ("query.cu", "gram.cu", "feature_bwd.cu",
                           "rgb_bwd.cu", "feature_bwd_topk.cu", "expand.cu")
             for r in kernels.ptxas_report(src)]
    rep = {}
    for label, (pattern, occupancy) in want.items():
        r = next((r for r in found if pattern in r["name"]), None)
        if r is None:
            fail(f"{label}: no ptxas report of an instantiation "
                 f"{pattern!r}")
        occ = occupancy()
        rep[label] = dict(ptxas=r, occupancy=occ)
        log(f"{label}: ptxas: {r['line']}; {r['stack']} bytes stack frame, "
            f"{r['spill_stores']} bytes spill stores, {r['spill_loads']} "
            f"bytes spill loads; {occ['blocks_per_sm']} block(s) of "
            f"{occ['threads']} threads, {occ['warps_per_sm']} warps an SM, "
            f"{occ['smem_bytes']} bytes of shared memory, "
            f"{occ['local_bytes']} local bytes")
        if r["spill_stores"] or r["spill_loads"] or occ["blocks_per_sm"] < 1:
            fail(f"{label} spills or does not fit on an SM: {rep[label]}")
    return rep


def check_kernels(dev) -> dict:
    """Phase 3: every kernel against its plain version, reduced scene."""
    h = w = 512
    model = from_numpy_params(bench_scene(50_000, seed=1), device=dev)
    view, pm, tfx, tfy = bench_camera(h, w)
    s = RasterizeSettings(h, w, tfx, tfy, 0, max_entries=1 << 20)
    clip = OpenCLIPNetwork("hash", device=dev)
    clip.set_positives(PROMPTS)
    x = stage_inputs(model, s, view, pm, clip.prompt_constants(model.codebooks),
                     dev)
    gx, gy = s.grid_x, s.grid_y
    errs = {}

    tile, depth, gauss, total = expand.expand_entries(
        x["proj"], x["op"], gx, gy, s.max_entries)
    proj = x["proj"]
    offsets = torch.cumsum(proj.tiles_touched, 0, dtype=torch.int64) \
        - proj.tiles_touched
    ref = expand.expand_entries_plain(proj, x["op"], offsets, gx, gy,
                                      s.max_entries, True,
                                      float(np.float32(255.0)))
    pairs = list(zip((tile, depth, gauss), ref))
    mismatch = sum(int((a != b).sum()) for a, b in pairs)
    errs["K1"] = max_diff(pairs)
    log(f"K1 expand: total {int(total)} entries, {mismatch} differ from the "
        f"plain version (must be 0)")
    if mismatch or int(total) >= s.max_entries:
        fail("K1 expansion differs from its plain version or overflowed")

    args = (x["g"], x["start"], x["count"], x["geom"], x["bg"], gx)
    stats = torch.zeros((2, 2), dtype=torch.int64, device=dev)
    out = blend.blend_tiles(*args, gy, x["qw"], x["qi"], L * K,
                            stats=stats[0])
    ref = blend.blend_tiles_plain(*args, x["qw"], x["qi"], L * K)
    rgb_only = blend.blend_tiles(*args, gy, stats=stats[1])
    rgb_ref = blend.blend_tiles_plain(*args)
    for st in stats:
        check_counts("K2 f32 (reduced scene)", st, *args[:4], gx)
    diffs = [float((a - b).abs().max()) for a, b in zip(out, ref)]
    diffs.append(float((rgb_only[0] - rgb_ref[0]).abs().max()))
    errs["K2"] = max(diffs)
    log(f"K2 blend: max |kernel - plain| rgb/feat/T/rgb-only = {diffs} "
        f"(atol 3e-5); live entries {x['live']}, "
        f"max tile count {int(x['count'].max())}")
    if not errs["K2"] <= 3e-5:
        fail("K2 blend differs from its plain version")

    errs["K2 non-finite rows"] = check_non_finite_rows(x, gx, gy)
    log(f"K2 on rows with NaN / inf xy or conic (f32 and fast16): max "
        f"|kernel - plain| {errs['K2 non-finite rows']} (atol 3e-5)")

    raw, nrm2 = query.query_map_tiles(out[1], x["phi"], x["gram"])
    raw_p, nrm2_p = query.query_map_tiles_plain(out[1], x["phi"], x["gram"])
    errs["K3"] = max(float((raw - raw_p).abs().max()),
                     float((nrm2 - nrm2_p).abs().max()))
    for a, b in ((raw, raw_p), (nrm2, nrm2_p)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    log(f"K3 query: max |kernel - plain| = {errs['K3']} (rtol/atol 1e-5)")
    torch.cuda.synchronize()
    return errs


def check_non_finite_rows(x, gx, gy) -> float:
    """K2 f32 and fast16 on the reduced scene with every 7th Gaussian's x,
    y or a conic term set to NaN, +inf or -inf (a steady frame's entries
    near depth 0): each kernel against its plain version, which skips a
    pair whose power is NaN (atol 3e-5, finite outputs)."""
    geom = x["geom"].clone()
    bad = torch.arange(0, geom.shape[0], 7, device=geom.device)
    specials = torch.tensor([math.nan, math.inf, -math.inf],
                            device=geom.device)
    geom[bad, bad % 5] = specials[bad % 3]
    rows = blend.pack_fast16_rows(geom[:, 0:2], geom[:, 2:5], geom[:, 5],
                                  geom[:, 6:9], x["qw"], x["qi"])
    seg = (x["g"], x["start"], x["count"])
    pairs = list(zip(
        blend.blend_tiles(*seg, geom, x["bg"], gx, gy, x["qw"], x["qi"],
                          L * K),
        blend.blend_tiles_plain(*seg, geom, x["bg"], gx, x["qw"], x["qi"],
                                L * K)))
    pairs += list(zip(
        blend.blend_tiles_fast16(*seg, rows, x["bg"], gx, gy, L * TOPK,
                                 L * K, False),
        blend.blend_tiles_fast16_plain(*seg, rows, x["bg"], gx, L * TOPK,
                                       L * K, False)))
    err = max_diff(pairs)
    if not (err <= 3e-5 and all(bool(torch.isfinite(a).all())
                                for a, _ in pairs)):
        fail(f"K2 on non-finite rows differs from its plain version by "
             f"{err} (atol 3e-5) or is not finite")
    return err


def frame(model, settings, view, pm, clip, consts, dev, events=None):
    out = render(settings, model, view, pm, np.zeros(3, np.float32),
                 np.zeros(3, np.float32), quick_render=True, device=dev,
                 stage_events=events)
    relev = clip.relevancy_from_tiles(
        out.language_feature_weight_map, *consts, settings.grid_x,
        settings.grid_y, settings.image_height, settings.image_width,
        stage_events=events)
    return out, relev


def main_path(model, clip, consts, dev) -> dict:
    """Phase 4: budgets probed as bench.py does, then the counted frames."""
    plans = {}
    for name, h, w, probe in LOADS:
        view, pm, tfx, tfy = bench_camera(h, w)
        s = RasterizeSettings(h, w, tfx, tfy, 0, max_entries=probe,
                              assemble=False)
        out, _ = frame(model, s, view, pm, clip, consts, dev)
        tot, live = int(out.total_entries), int(out.live_total)
        if tot >= probe:
            fail(f"{name}: probe budget saturated ({tot} >= {probe})")
        budget = min(-(-int(tot * 1.07) // 4096) * 4096, probe)
        live_b = min(-(-int(live * 1.07) // 4096) * 4096, budget)
        plans[name] = (s._replace(max_entries=budget, live_entries=live_b),
                       view, pm)
        log(f"{name}: probe total {tot}, live {live} -> budgets "
            f"{budget} / {live_b}")
    zero_counts(WRAPPERS)
    results = {}
    for name, (s, view, pm) in plans.items():
        host_ms, stages = [], []
        for _ in range(FRAMES):
            events = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, relev = frame(model, s, view, pm, clip, consts, dev, events)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            stages.append({b[0]: a[1].elapsed_time(b[1])
                           for a, b in zip(events, events[1:])})
        tot, live = int(out.total_entries), int(out.live_total)
        wm = out.language_feature_weight_map
        n_tiles = s.grid_x * s.grid_y
        checks = {
            "total < max_entries": tot < s.max_entries,
            "live_total <= total": live <= tot,
            "live_total <= live_entries": live <= s.live_entries,
            "live_total > 0": live > 0,
            "map shape": tuple(wm.shape) == (n_tiles, 256, L * K),
            "relevancy shape": tuple(relev.shape) == (L, len(PROMPTS),
                                                      s.image_height,
                                                      s.image_width),
            "finite": all(bool(torch.isfinite(t).all()) for t in
                          (out.render, wm, out.final_transmittance, relev)),
            "relevancy in [0, 1]": bool(((relev >= 0) & (relev <= 1)).all()),
        }
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"{name}: checks failed: {bad}")
        stage_ms = {k: statistics.median(st[k] for st in stages)
                    for k in stages[0]}
        results[name] = dict(
            frame_ms_median=statistics.median(host_ms), frame_ms=host_ms,
            stage_ms_median=stage_ms, total_entries=tot, live_total=live,
            max_entries=s.max_entries, live_entries=s.live_entries,
            max_tile_count=int(out.max_tile_count))
        log(f"{name}: median frame {results[name]['frame_ms_median']:.3f} ms "
            f"over {FRAMES} frames; stages (median ms) "
            + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items()))
    launches = read_counts(WRAPPERS)
    log(f"launches on the main path ({2 * FRAMES} frames): {launches}")
    if not all(v > 0 for v in launches.values()):
        fail(f"a kernel of the path was not launched: {launches}")
    return dict(loads=results, launches=launches, plans=plans)


def max_diff(pairs) -> float:
    return max(float((a - b).abs().max()) for a, b in pairs)


def check_counts(label: str, stats, g, start, count, geom, gx: int,
                 cells: bool = False) -> tuple[int, int]:
    """K2's pair counts (`stats`, evaluated and included) against
    pair_counts_plain on the same segments: integers, so equal. geom
    [N, 9] (the unpacked rows for fast16)."""
    got = (int(stats[0]), int(stats[1]))
    want = blend.pair_counts_plain(g, start, count, geom, gx, cells)
    if got != want:
        fail(f"{label}: K2's pair counts {got} differ from "
             f"pair_counts_plain's {want}")
    return got


def kernels_at_main_shapes(model, clip, consts, plans, dev) -> dict:
    """Phase 5: at each load, every kernel (through its wrapper) on the
    main path's inputs, held against its plain version on the same inputs
    (K1 exact, K2 atol 3e-5, K3 rtol/atol 1e-5) and timed beside it, its
    bound for this run's data, and for K3 the einsum form."""
    rows = {}
    for name, (s, view, pm) in plans.items():
        x = stage_inputs(model, s, view, pm, consts, dev)
        gx, gy = s.grid_x, s.grid_y
        n = x["op"].shape[0]
        proj = x["proj"]
        n_on = int((proj.tiles_touched > 0).sum())
        offsets = torch.cumsum(proj.tiles_touched, 0, dtype=torch.int64) \
            - proj.tiles_touched
        r = {}
        k1 = lambda: expand.expand_entries(proj, x["op"], gx, gy,  # noqa: E731
                                           s.max_entries)
        k1_plain = lambda: expand.expand_entries_plain(  # noqa: E731
            proj, x["op"], offsets, gx, gy, s.max_entries, True,
            float(np.float32(255.0)))
        ms, out = cuda_ms(k1, 20)
        plain_ms, ref = cuda_ms(k1_plain, 3)
        pairs = list(zip(out[:3], ref))
        mismatch = sum(int((a != b).sum()) for a, b in pairs)
        r["K1"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                       max_abs_err=max_diff(pairs), mismatches=mismatch,
                       gaussians_on_screen=n_on,
                       off_screen_share=1.0 - n_on / n)
        r["K1"]["bound_ms"], r["K1"]["bound_by"] = bound(
            n * 12 + n_on * 44 + s.max_entries * 12,
            x["total"] * CULL_FLOPS)
        if mismatch:
            fail(f"{name}: K1 differs from its plain version in {mismatch} "
                 "outputs")
        del out, ref, pairs

        args = (x["g"], x["start"], x["count"], x["geom"], x["bg"], gx)
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        blend.blend_tiles(*args, gy, x["qw"], x["qi"], L * K, stats=stats)
        n_eval, n_inc = check_counts(f"{name} K2 f32", stats, *args[:4], gx)
        k2 = lambda: blend.blend_tiles(*args, gy, x["qw"], x["qi"],  # noqa: E731
                                       L * K)
        k2_plain = lambda: blend.blend_tiles_plain(  # noqa: E731
            *args, x["qw"], x["qi"], L * K)
        ms, out = cuda_ms(k2, 10)
        plain_ms, ref = cuda_ms(k2_plain, 1)
        distinct = int(torch.unique(x["g"][:x["live"]]).numel())
        r["K2"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                       max_abs_err=max_diff(zip(out, ref)),
                       pairs_evaluated=n_eval, pairs_included=n_inc,
                       distinct_gaussians=distinct)
        n_tiles = gx * gy
        r["K2"]["bound_ms"], r["K2"]["bound_by"] = bound(
            x["live"] * 4 + n_tiles * 8 + distinct * (9 * 4 + L * TOPK * 8)
            + n_tiles * 256 * (3 + L * K + 1) * 4,
            n_eval * BLEND_ALPHA_FLOPS + n_inc * BLEND_INCLUDE_FLOPS)
        if not r["K2"]["max_abs_err"] <= 3e-5:
            fail(f"{name}: K2 differs from its plain version by "
                 f"{r['K2']['max_abs_err']} (atol 3e-5)")
        feat = out[1]
        del out, ref

        r["K3"] = check_query_f32(feat, x["phi"], x["gram"], name)
        rows[name] = r
        for k, v in r.items():
            log(f"{name} {k}: " + ", ".join(
                f"{a} {b!r}" for a, b in v.items()))
        del x, feat
        torch.cuda.empty_cache()
    return rows


def check_query_f32(feat, phi, gram, label: str) -> dict:
    """K3 on a frame's f32 map against its plain version (rtol/atol 1e-5),
    timed beside it, its bound (the map read once; the products at the
    3xTF32 rate) and the einsum pair."""
    pq = phi.shape[2]
    k3 = lambda: query.query_map_tiles(feat, phi, gram)  # noqa: E731
    k3_plain = lambda: query.query_map_tiles_plain(  # noqa: E731
        feat, phi, gram)
    wm3 = feat.reshape(-1, L, K)

    def k3_einsum():
        torch.einsum("qlk,lkp->qlp", wm3, phi)
        torch.einsum("qlk,lkm,qlm->ql", wm3, gram, wm3)

    ms, out = cuda_ms(k3, 20)
    plain_ms, ref = cuda_ms(k3_plain, 5)
    q = feat.shape[0] * 256
    flops = q * L * 2 * K * (K + pq + 1)
    r = dict(ms=ms, plain_ms=plain_ms, library_ms=cuda_ms(k3_einsum, 5)[0],
             max_abs_err=max_diff(zip(out, ref)),
             cuda_core_ops_ms=flops / F32_FLOPS * 1e3)
    r["bound_ms"], r["bound_by"] = bound(
        q * L * K * 4 + (L * K * pq + L * K * K) * 4 + q * L * (pq + 1) * 4,
        flops, F32_TENSOR_FLOPS)
    if not all(torch.allclose(a, b, rtol=1e-5, atol=1e-5)
               for a, b in zip(out, ref)):
        fail(f"{label}: K3 differs from its plain version by "
             f"{r['max_abs_err']} (rtol/atol 1e-5)")
    return r


def train_scene(n: int, seed: int, dev, k: int = TRAIN_K):
    """scripts/profile_train.py:38-48 (same draws in the same order) with
    create_from_pcd's other fields (identity rotations, SH degree-3 slots
    at active degree 0); logits and codebooks (one level of k codes) from
    a torch.Generator."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-4, 4, (n, 2)),
                          rng.uniform(2.0, 12.0, (n, 1))], 1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opacity = rng.uniform(-1, 2, (n, 1)).astype(np.float32)
    scaling = np.log(rng.uniform(0.004, 0.04, (n, 3))).astype(np.float32)
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1.0
    model = from_numpy_params(dict(
        xyz=pts, features_dc=((cols - 0.5) / 0.28209479177387814)[:, None, :],
        features_rest=np.zeros((n, 15, 3), np.float32), scaling=scaling,
        rotation=rot, opacity=opacity), active_sh_degree=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return init_language_features(model, 1, k, generator=gen), rng


def write_gt(rng, prefix: str, n_cams: int, h: int, w: int, cell: int = 48,
             out_dir: str = GT_DIR):
    """A TRAIN_S x 512 segment table and, per camera, a segment map of
    cell x cell blocks with ~5% of pixels at -1, as <name>_f.npy and
    <name>_s.npy (all 4 SAM levels alike) under `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    table = rng.normal(size=(TRAIN_S, 512)).astype(np.float32)
    for i in range(n_cams):
        ids = rng.integers(0, TRAIN_S, (-(-h // cell), -(-w // cell)))
        seg = np.repeat(np.repeat(ids, cell, 0), cell, 1)[:h, :w]
        seg = seg.astype(np.int32)
        seg[rng.uniform(size=(h, w)) < 0.05] = -1
        np.save(os.path.join(out_dir, f"{prefix}{i}_s.npy"),
                np.broadcast_to(seg, (4, h, w)))
        np.save(os.path.join(out_dir, f"{prefix}{i}_f.npy"), table)


def train_cameras(prefix: str, yaws, h: int, w: int, images=None) -> list:
    fovy = math.radians(60)
    fovx = 2 * math.atan(math.tan(fovy / 2) * w / h)
    cams = []
    for i, deg in enumerate(yaws):
        t = math.radians(deg)
        R = np.array([[math.cos(t), 0, math.sin(t)], [0, 1, 0],
                      [-math.sin(t), 0, math.cos(t)]])
        cams.append(Camera(i, R, np.zeros(3), fovx, fovy,
                           None if images is None else images[i],
                           f"{prefix}{i}", i, w, h))
    return cams


def train_step_inputs(model, cam, max_entries: int, live: int, dev) -> dict:
    """What the kernels of one training step get (the calls of
    render(include_feature=True) and the fused loss), for holding them
    against their plain versions and timing them alone."""
    s = make_settings(cam, 0, 1.0, max_entries, live_entries=live)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    gx, gy = s.grid_x, s.grid_y
    with torch.no_grad():
        qw, qi = model.get_weights_and_indices(TRAIN_TOPK)
        qw, qi = qw.contiguous(), qi.int().contiguous()
        op = model.get_opacity()[:, 0].contiguous()
        proj = projection.preprocess(
            model.xyz, model.get_scaling(), model.get_rotation(),
            model.get_features(), None, T(cam.world_view_transform),
            T(cam.full_proj_transform), T(cam.camera_center), s.tanfovx,
            s.tanfovy, s.image_width, s.image_height, 0, opacities=op)
        g, start, count, total, live_total = sorted_binning(s, proj, op)
        geom = blend.pack_gaussian_state(proj.xy, proj.conic, op, proj.rgb)
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        _, wmap, _ = blend.blend_tiles(g, start, count, geom,
                                       torch.zeros(3, device=dev), gx, gy, qw,
                                       qi, model.codebooks.shape[1],
                                       stats=stats)
        check_counts("K2 f32 (feature step)", stats, g, start, count, geom,
                     gx)
        table, seg = cam.get_language_feature_compact(GT_DIR, 1)
        table, seg = T(table), T(seg)
        rhs, gfull = gram.prep(model.codebooks, table, 0)
    n_cov = int(count.sum())
    return dict(settings=s, g=g, start=start, count=count, geom=geom, qw=qw,
                qi=qi, wmap=wmap, table=table, seg=seg,
                seg_t=gram.seg_to_tiles(seg, gx, gy), rhs=rhs, gfull=gfull,
                total=int(total), live_total=int(live_total), covered=n_cov,
                n_eval=int(stats[0]), n_inc=int(stats[1]),
                distinct=int(torch.unique(g[:n_cov]).numel()),
                codebooks=model.codebooks.detach())


def normalized_err(a, b) -> tuple[float, float]:
    """(max |a - b|, the same over max |b|)."""
    err = float((a - b).abs().max())
    return err, err / max(float(b.abs().max()), 1e-30)


def check_train_kernels(x: dict, dev, timed: bool) -> dict:
    """K6a, K6b and K4 on one step's inputs against their plain versions
    (K6a per-tile sums rtol 1e-5 / atol 1e-4; K6b and K4 within 1e-4 and
    1e-5 of their largest output entry: atomics and sums of 256 terms in
    other orders), and the fused loss against the plain autograd of
    trainer._gram_cos_core (value rtol 1e-5, gradients 1e-4 of their
    largest entry). With `timed`, each kernel's time, its plain version's
    and its bound for this data."""
    s = x["settings"]
    gx, gy = s.grid_x, s.grid_y
    hw = s.image_height * s.image_width
    K, C = x["codebooks"].shape[1], x["wmap"].shape[2]
    M = x["gfull"].shape[0]
    seg_t, wmap, rhs, gfull = x["seg_t"], x["wmap"], x["rhs"], x["gfull"]
    up = torch.ones((), device=dev)
    r = {}

    k6a = lambda: gram.gram_tiles_fwd(seg_t, wmap, rhs, gfull)  # noqa: E731
    k6a_plain = lambda: gram.gram_tiles_fwd_plain(  # noqa: E731
        seg_t, wmap, rhs, gfull, 1e-8)
    out, ref = k6a(), k6a_plain()
    err = normalized_err(out, ref)
    r["K6a"] = dict(max_abs_err=err[0], rel_err=err[1])
    if not torch.allclose(out, ref, rtol=1e-5, atol=1e-4):
        fail(f"K6a differs from its plain version by {err[0]}")

    k6b = lambda: gram.gram_tiles_bwd(  # noqa: E731
        seg_t, wmap, rhs, gfull, 0, K, 1e-8, 1.0 / hw, up)
    k6b_plain = lambda: gram.gram_tiles_bwd_plain(  # noqa: E731
        seg_t, wmap, rhs, gfull, 0, K, 1e-8, 1.0 / hw, up)
    out, ref = k6b(), k6b_plain()
    errs = [normalized_err(a, b) for a, b in zip(out, ref)]
    r["K6b"] = dict(max_abs_err=max(e[0] for e in errs),
                    rel_err=max(e[1] for e in errs))
    if not r["K6b"]["rel_err"] <= 1e-4:
        fail(f"K6b differs from its plain version: {errs}")
    cot = out[0]
    del out, ref

    args = (x["g"], x["start"], x["count"], x["geom"], cot)
    k4 = lambda: train.feature_grads(*args, gx, gy)  # noqa: E731
    k4_plain = lambda: train.feature_grads_plain(*args, gx)  # noqa: E731
    out, ref = k4(), k4_plain()
    err = normalized_err(out, ref)
    r["K4"] = dict(max_abs_err=err[0], rel_err=err[1])
    if not err[1] <= 1e-5:
        fail(f"K4 differs from its plain version by {err} (abs, relative)")
    del out, ref

    vals, grads = [], []
    for fn in (gram.gram_loss_fused, trainer.gram_cos_loss_tiles):
        cb = x["codebooks"].clone().requires_grad_(True)
        wm = wmap.clone().requires_grad_(True)
        loss = fn(cb, wm, x["table"], x["seg"], 0)
        loss.backward()
        vals.append(float(loss.detach()))
        grads.append((cb.grad, wm.grad))
    g_err = [normalized_err(a, b)[1] for a, b in zip(*grads)]
    r["loss_vs_xla_core"] = dict(fused=vals[0], xla=vals[1], grad_rel=g_err)
    if not (math.isclose(vals[0], vals[1], rel_tol=1e-5)
            and max(g_err) <= 1e-4):
        fail(f"the fused loss differs from the XLA formulation: "
             f"{r['loss_vs_xla_core']}")
    del grads
    if not timed:
        return r

    # K4 needs only the entries the tiles cover: its g read and dF write
    # count x["covered"] rows, not the live budget's padding.
    q = x["seg_t"].numel()
    k6b_bytes, k6b_ops = k6b_work(q, M, C, K, rhs, gfull)
    for name, fn, plain, reps, nbytes, ops in (
            ("K6a", k6a, k6a_plain, 20, *k6a_work(q, M, rhs, gfull)),
            ("K6b", k6b, k6b_plain, 10, k6b_bytes, k6b_ops),
            ("K4", k4, k4_plain, 10,
             x["covered"] * 4 + gx * gy * 8 + x["distinct"] * 24
             + cot.numel() * 4 + x["covered"] * C * 4,
             x["n_eval"] * BLEND_ALPHA_FLOPS + x["n_inc"] * (3 + 2 * C))):
        r[name]["ms"] = cuda_ms(fn, reps)[0]
        r[name]["plain_ms"] = cuda_ms(plain, 1)[0]
        r[name]["library_ms"] = None
        r[name]["bound_ms"], r[name]["bound_by"] = bound(nbytes, ops,
                                                         F32_TENSOR_FLOPS)
    # K4 at C = 192 (the 3-level map's width) on the same blend, beside
    # C = 64: a seeded cotangent, held to its plain version as above.
    gen = torch.Generator(device=dev).manual_seed(192)
    cot192 = torch.randn(gx * gy, 256, 192, device=dev, generator=gen)
    args192 = (x["g"], x["start"], x["count"], x["geom"], cot192)
    out = train.feature_grads(*args192, gx, gy)
    err = normalized_err(out, train.feature_grads_plain(*args192, gx))
    del out
    if not err[1] <= 1e-5:
        fail(f"K4 at C = 192 differs from its plain version by {err}")
    r["K4 C=192"] = dict(
        max_abs_err=err[0], rel_err=err[1],
        ms=cuda_ms(lambda: train.feature_grads(*args192, gx, gy), 10)[0])
    r["K4 C=192"]["bound_ms"], r["K4 C=192"]["bound_by"] = bound(
        x["covered"] * 4 + gx * gy * 8 + x["distinct"] * 24
        + cot192.numel() * 4 + x["covered"] * 192 * 4,
        x["n_eval"] * BLEND_ALPHA_FLOPS + x["n_inc"] * (3 + 2 * 192),
        F32_TENSOR_FLOPS)
    return r


def k6a_work(q: int, M: int, rhs, gfull) -> tuple:
    """(bytes, operations) K6a needs on q pixels: seg and w [q, M] read, rhs
    and G read once, the per-tile sums written; G w (2M^2), n2, num and the
    chain (4M + 10) a pixel."""
    return (q * (M + 1) * 4 + rhs.numel() * 4 + gfull.numel() * 4
            + q // 256 * 4, q * (2 * M * M + 4 * M + 10))


def k6b_work(q: int, M: int, C: int, K: int, rhs, gfull) -> tuple:
    """(bytes, operations) K6b needs on q pixels: seg, w [q, M], rhs and G
    read once, d_w [q, C], d_phi and d_G written once. Per pixel, G w
    (2M^2), n2, num and the chain (4M + 10), then d_w (4K), d_phi (2K) and
    d_G (2MK + K)."""
    nbytes = (q * (M + 1) * 4 + rhs.numel() * 4 + gfull.numel() * 4
              + q * C * 4 + (rhs.shape[0] + M) * K * 4)
    return nbytes, q * (2 * M * M + 4 * M + 10) + q * (7 * K + 2 * M * K)


def check_gram_patterns(dev) -> dict:
    """K6b against its plain version (1e-4 of the largest entry) on the
    segment patterns its d_phi treats apart, at M = 64, 128 and 192, 3
    tiles each; a tile of -1 only gives all-zero outputs."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_port_fixtures import GRAM_PATTERNS, gram_pattern_case

    res = {}
    for m in (64, 128, 192):
        for i, pattern in enumerate(GRAM_PATTERNS):
            case = {k: torch.as_tensor(v, device=dev) for k, v in
                    gram_pattern_case(pattern, m, 3, 10 * m + i).items()}
            rhs, gfull = gram.prep(case["codebooks"], case["table"],
                                   m // TRAIN_K - 1)
            args = (case["seg"], case["w"], rhs, gfull, m // TRAIN_K - 1,
                    TRAIN_K, 1e-8, 1.0 / case["seg"].numel(),
                    torch.tensor(1.5, device=dev))
            out = gram.gram_tiles_bwd(*args)
            ref = gram.gram_tiles_bwd_plain(*args)
            rel = max(normalized_err(a, b)[1] if b.abs().max() > 0
                      else float(a.abs().max()) for a, b in zip(out, ref))
            res[f"M={m} {pattern}"] = rel
            if not rel <= 1e-4:
                fail(f"K6b at M={m} on {pattern} differs from its plain "
                     f"version by {rel} of its largest output")
    return res


def gram_wide_inputs(dev, layers: int = 3):
    """Random inputs of the Gram loss at the last layer of a `layers`-level
    curriculum (M = 64 layers): 272x480 (30x17 tiles), 256 segments with ~5%
    of pixels at -1, a [T, 256, 64 layers] map. Returns (seg_t, wm, rhs, G,
    H*W)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    gx, gy, h, w, S = 30, 17, 272, 480, 256
    wm = torch.randn(gx * gy, 256, layers * TRAIN_K, device=dev,
                     generator=gen)
    seg = torch.randint(0, S, (h, w), device=dev, generator=gen,
                        dtype=torch.int32)
    seg[torch.rand(h, w, device=dev, generator=gen) < 0.05] = -1
    books = torch.randn(layers, TRAIN_K, 512, device=dev, generator=gen)
    rhs, gfull = gram.prep(books, torch.randn(S, 512, device=dev,
                                              generator=gen), layers - 1)
    return gram.seg_to_tiles(seg, gx, gy), wm, rhs, gfull, h * w


def check_gram_wide(dev, layers: int = 3) -> dict:
    """K6a/K6b at the last layer of a `layers`-level curriculum (M = 192 at
    3, 256 at 4) on gram_wide_inputs, against their plain versions (K6a's
    per-tile sums rtol 1e-5 / atol 1e-4, K6b 1e-4 of the largest), each
    timed beside its plain version and its bound."""
    seg_t, wm, rhs, gfull, hw = gram_wide_inputs(dev, layers)
    lay, M = layers - 1, layers * TRAIN_K
    a = gram.gram_tiles_fwd(seg_t, wm, rhs, gfull)
    b = gram.gram_tiles_fwd_plain(seg_t, wm, rhs, gfull, 1e-8)
    up = torch.ones((), device=dev)
    args = (seg_t, wm, rhs, gfull, lay, TRAIN_K, 1e-8, 1.0 / hw, up)
    errs = [normalized_err(a, b)] + [
        normalized_err(u, v) for u, v in zip(
            gram.gram_tiles_bwd(*args), gram.gram_tiles_bwd_plain(*args))]
    if not (torch.allclose(a, b, rtol=1e-5, atol=1e-4)
            and max(e[1] for e in errs[1:]) <= 1e-4):
        fail(f"K6 at M={M} differs from its plain version: {errs}")
    fwd = (seg_t, wm, rhs, gfull)
    q = seg_t.numel()
    res = dict(M=M, K6a=errs[0][0], K6b=max(e[0] for e in errs[1:]),
               rel=[e[1] for e in errs])
    for name, fn, plain, work in (
            ("K6a", lambda: gram.gram_tiles_fwd(*fwd),
             lambda: gram.gram_tiles_fwd_plain(*fwd, 1e-8),
             k6a_work(q, M, rhs, gfull)),
            ("K6b", lambda: gram.gram_tiles_bwd(*args),
             lambda: gram.gram_tiles_bwd_plain(*args),
             k6b_work(q, M, wm.shape[2], TRAIN_K, rhs, gfull))):
        res[f"{name}_timed"] = t = dict(ms=cuda_ms(fn, 20)[0],
                                        plain_ms=cuda_ms(plain, 1)[0],
                                        library_ms=None)
        t["bound_ms"], t["bound_by"] = bound(*work, F32_TENSOR_FLOPS)
    return res


def train_checks_reduced(dev) -> dict:
    """Phase 6: the training kernels on a reduced scene (50k Gaussians,
    272x480, one camera) and K6 at M = 192."""
    model, rng = train_scene(50_000, 1, dev)
    write_gt(rng, "small", 1, 272, 480)
    cam = train_cameras("small", (0.0,), 272, 480)[0]
    x = train_step_inputs(model, cam, 1 << 20, 0, dev)
    r = check_train_kernels(x, dev, timed=False)
    r["wide"] = check_gram_wide(dev)
    r["patterns"] = check_gram_patterns(dev)
    for k in ("K4", "K6a", "K6b"):
        log(f"reduced {k}: max |kernel - plain| {r[k]['max_abs_err']!r} "
            f"({r[k]['rel_err']!r} of the largest)")
    log(f"reduced: fused loss vs XLA core {r['loss_vs_xla_core']}; "
        f"M=192 {r['wide']}; K6b on the segment patterns (of the largest) "
        f"{r['patterns']}")
    torch.cuda.synchronize()
    return r


def train_path(dev) -> dict:
    """Phase 7: train_features at full width, the launch counts of the
    run, then the kernels on one step's own inputs."""
    t0 = time.perf_counter()
    model, rng = train_scene(TRAIN_N, 0, dev)
    write_gt(rng, "cam", len(TRAIN_YAW_DEG), TRAIN_H, TRAIN_W)
    cams = train_cameras("cam", TRAIN_YAW_DEG, TRAIN_H, TRAIN_W)
    log(f"training scene: {TRAIN_N} Gaussians, {TRAIN_H}x{TRAIN_W}, L=1 "
        f"K={TRAIN_K} top-{TRAIN_TOPK}, {len(cams)} cameras, GT table "
        f"{TRAIN_S}x512 ({time.perf_counter() - t0:.1f} s)")
    opt = type("Opt", (), {"language_feature_lr": 0.0025})()
    max_entries = 2 ** 21
    step_ms, metrics_log = [], []
    clock = [None]

    def on_iteration(_it, _model, _opt, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - clock[0]) * 1e3)
        clock[0] = now
        metrics_log.append({k: float(v) for k, v in metrics.items()})

    zero_counts(TRAIN_WRAPPERS)
    redone0 = tracing.counters().get("feature_step.redone", 0)
    clock[0] = time.perf_counter()
    model, optimizer, logs = trainer.train_features(
        model, cams, opt, GT_DIR, 1, iterations=TRAIN_ITERS, seed=0,
        max_entries=max_entries, feature_cache={}, on_iteration=on_iteration,
        device=dev)
    launches = read_counts(TRAIN_WRAPPERS)
    redone = tracing.counters().get("feature_step.redone", 0) - redone0
    losses = logs.losses
    budget = list(logs.live_budget.values())
    live = [int(m["live_total"]) for m in metrics_log]
    tot = [int(m["total_entries"]) for m in metrics_log]
    per_step = {k: v / TRAIN_ITERS for k, v in launches.items()}
    log(f"training: {TRAIN_ITERS} steps, median {statistics.median(step_ms):.3f}"
        f" ms a step (host clock + synchronize); loss first {losses[0]!r} "
        f"last {losses[-1]!r}; live_total {min(live)}..{max(live)} against "
        f"the live budget {budget}; total_entries {max(tot)} against "
        f"max_entries {max_entries}")
    log(f"launches on the training path ({TRAIN_ITERS} steps): {launches}; "
        f"per step {per_step}")
    if not all(v > 0 for v in launches.values()):
        fail(f"a kernel of the training path was not launched: {launches}")
    # The top-k codes: one launch forward an attempt (a redone step runs its
    # forward again), one backward a step.
    if launches["TOPK"] != 2 * TRAIN_ITERS + redone:
        fail(f"the training path's top-k codes launched {launches['TOPK']} "
             f"times in {TRAIN_ITERS} steps and {redone} redone forwards")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite training loss: {losses}")
    if not statistics.mean(losses[-4:]) < statistics.mean(losses[:4]):
        fail(f"the training loss did not fall: {losses}")
    if max(tot) >= max_entries or max(live) > max(budget):
        fail("the training run saturated its entry budgets")

    x = train_step_inputs(model, cams[0], max_entries, budget[0], dev)
    rows = check_train_kernels(x, dev, timed=True)
    # Stages of one step, each timed alone on the same inputs.
    s = x["settings"]._replace(assemble=False)
    c = cams[0]
    view, proj, campos = (c.world_view_transform, c.full_proj_transform,
                          c.camera_center)
    zero3 = np.zeros(3, np.float32)
    with torch.no_grad():
        fwd = lambda: render(s, model, view, proj, campos, zero3,  # noqa: E731
                             include_feature=True, topk=TRAIN_TOPK, device=dev)
        codes = lambda: model.get_weights_and_indices(TRAIN_TOPK)  # noqa: E731
        dfeat = train.feature_grads(x["g"], x["start"], x["count"], x["geom"],
                                    x["wmap"], s.grid_x, s.grid_y)
        red = lambda: train.reduce_to_gaussians(  # noqa: E731
            dfeat, x["g"], x["qi"])
        stages = {"render forward (preprocess, K1, sort, K2, top-k)":
                  cuda_ms(fwd, 5)[0],
                  "top-k codes (inside the forward)": cuda_ms(codes, 5)[0],
                  "K6a gram forward": rows["K6a"]["ms"],
                  "K6b gram backward": rows["K6b"]["ms"],
                  "K4 feature backward": rows["K4"]["ms"],
                  "projection + index_add_": cuda_ms(red, 5)[0],
                  "Adam step": cuda_ms(optimizer.step, 5)[0]}
    del dfeat
    for k, v in rows.items():
        log(f"training {k}: " + ", ".join(f"{a} {b!r}" for a, b in v.items()))
    log("training stages (ms, each alone): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    return dict(step_ms_median=statistics.median(step_ms), step_ms=step_ms,
                losses=losses, live_budget=budget, live_total=live,
                total_entries=tot, max_entries=max_entries,
                launches=launches, launches_per_step=per_step,
                redone=redone, kernels=rows, stage_ms=stages,
                step_entries=dict(total=x["total"], live=x["live_total"],
                                  pairs_evaluated=x["n_eval"],
                                  pairs_included=x["n_inc"],
                                  distinct_gaussians=x["distinct"]))


def rgb_scene(n: int, h: int, w: int, n_cams: int, seed: int, dev):
    """scripts/profile_rgb_train.py:29-48 (same draws in the same order):
    create_from_pcd on seeded points (scales from the 3-NN, then replaced),
    logit opacity U(-1, 2), scales U(0.004, 0.04), all 16 SH coefficients
    active, and one U(0, 1) image per camera."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-4, 4, (n, 2)),
                          rng.uniform(2.0, 12.0, (n, 1))], 1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    model = create_from_pcd(pts, cols, 1.0, device=dev)
    T = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa: E731
    model = model.replace(
        opacity=T(rng.uniform(-1, 2, (n, 1))),
        scaling=torch.log(T(rng.uniform(0.004, 0.04, (n, 3)))),
        active_sh_degree=3)
    images = [rng.uniform(0, 1, (3, h, w)).astype(np.float32)
              for _ in range(n_cams)]
    return model, images


def rgb_step_inputs(model, cam, max_entries: int, dev) -> dict:
    """What K1, K2 and K7 get in one geometry step on `cam` (the calls of
    render's RGB mode: preprocess, K1 + sort, K2 with bg = 0), with K1's
    and K2's outputs and the loss's own cotangents of the tile colour and
    final transmittance packed for K7."""
    s = make_settings(cam, model.active_sh_degree, 1.0, max_entries)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    gx, gy = s.grid_x, s.grid_y
    zero3 = torch.zeros(3, device=dev)
    with torch.no_grad():
        op = model.get_opacity()[:, 0].contiguous()
        proj = projection.preprocess(
            model.xyz, model.get_scaling(), model.get_rotation(),
            model.get_features(), None, T(cam.world_view_transform),
            T(cam.full_proj_transform), T(cam.camera_center), s.tanfovx,
            s.tanfovy, s.image_width, s.image_height, s.sh_degree,
            opacities=op)
        k1 = expand.expand_entries(proj, op, gx, gy, s.max_entries,
                                   cull_alpha=s.cull_alpha)
        g, start, count = expand.sort_entries(*k1[:3], gx * gy)
        geom = blend.pack_gaussian_state(proj.xy, proj.conic, op, proj.rgb)
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        rgb_t, _, t_t = blend.blend_tiles(g, start, count, geom, zero3, gx,
                                          gy, stats=stats)
        check_counts("K2 rgb (geometry step)", stats, g, start, count, geom,
                     gx)
    rgb_l = rgb_t.clone().requires_grad_(True)
    img = rasterize_tiles.tiles_to_image(rgb_l, gx, gy, s.image_height,
                                         s.image_width)
    gt = T(cam.image)
    loss = 0.8 * losses.l1_loss(img, gt) + 0.2 * (1.0 - losses.ssim(img, gt))
    loss.backward()
    g_t = torch.zeros_like(t_t)     # bg = 0: the final T gets no gradient
    n_cov = int(count.sum())
    return dict(settings=s, proj=proj, op=op, k1=k1[:3], g=g, start=start,
                count=count, geom=geom, rgb_t=rgb_t, t_t=t_t,
                g_rgb=rgb_l.grad, g_t=g_t,
                pack=rgb_train.make_pack(rgb_t, t_t, rgb_l.grad, g_t),
                total=int(k1[3]), covered=n_cov, n_eval=int(stats[0]),
                n_inc=int(stats[1]),
                distinct=int(torch.unique(g[:n_cov]).numel()))


def check_rgb_kernels(x: dict, dev, timed: bool) -> dict:
    """Each kernel of the geometry step on that step's inputs against its
    plain version: K1's entries exact; K2's rgb-only colour and final T
    (bg = 0) atol 3e-5; K7 within 1e-5 of its largest output (sums over
    256 pixels in another order); and RGBTrainBlend's gradients against
    the chain of plain versions (blend_tiles_plain, rgb_grads_plain,
    index_add_; 1e-4 of the largest, since index_add_ adds with atomics).
    With `timed`, K7's time, its plain version's and its bound for this
    data."""
    s = x["settings"]
    gx, gy = s.grid_x, s.grid_y
    proj, op = x["proj"], x["op"]
    offsets = torch.cumsum(proj.tiles_touched, 0, dtype=torch.int64) \
        - proj.tiles_touched
    ref = expand.expand_entries_plain(
        proj, op, offsets, gx, gy, s.max_entries, True,
        float(np.float32(1.0 / s.cull_alpha)))
    pairs = list(zip(x["k1"], ref))
    mismatch = sum(int((a != b).sum()) for a, b in pairs)
    r = {"K1": dict(max_abs_err=max_diff(pairs), mismatches=mismatch)}
    if mismatch:
        fail(f"K1 differs from its plain version in {mismatch} outputs")
    del ref, pairs

    rgb_p, _, t_p = blend.blend_tiles_plain(
        x["g"], x["start"], x["count"], x["geom"],
        torch.zeros(3, device=dev), gx)
    r["K2"] = dict(max_abs_err=max(float((x["rgb_t"] - rgb_p).abs().max()),
                                   float((x["t_t"] - t_p).abs().max())))
    if not r["K2"]["max_abs_err"] <= 3e-5:
        fail(f"K2 rgb (bg = 0) differs from its plain version by "
             f"{r['K2']['max_abs_err']} (atol 3e-5)")

    args = (x["g"], x["start"], x["count"], x["geom"], x["pack"])
    k7 = lambda: rgb_train.rgb_grads(*args, gx, gy)  # noqa: E731
    k7_plain = lambda: rgb_train.rgb_grads_plain(*args, gx)  # noqa: E731
    out, ref = k7(), k7_plain()
    err = normalized_err(out, ref)
    r["K7"] = dict(max_abs_err=err[0], rel_err=err[1])
    if not err[1] <= 1e-5:
        fail(f"K7 differs from its plain version by {err} (abs, relative)")
    del out, ref

    leaves = [t.detach().clone().requires_grad_(True)
              for t in (proj.xy, proj.conic, op, proj.rgb)]
    rgb_k, t_k = rgb_train.RGBTrainBlend.apply(
        *leaves, x["g"], x["start"], x["count"], gx, gy)
    torch.autograd.backward([rgb_k, t_k], [x["g_rgb"], x["g_t"]])
    pack_p = rgb_train.make_pack(rgb_p, t_p, x["g_rgb"], x["g_t"])
    rows = rgb_train.rgb_grads_plain(x["g"], x["start"], x["count"],
                                     x["geom"], pack_p, gx)
    per = rgb_train.reduce_to_gaussians(rows, x["g"], op.shape[0])
    want = (per[:, 0:2], per[:, 2:5], per[:, 5], per[:, 6:9])
    errs = [normalized_err(a.grad, b) for a, b in zip(leaves, want)]
    fwd_err = max(float((rgb_k.detach() - rgb_p).abs().max()),
                  float((t_k.detach() - t_p).abs().max()))
    r["chain"] = dict(grad_rel=[e[1] for e in errs], forward_err=fwd_err)
    if not (max(e[1] for e in errs) <= 1e-4 and fwd_err <= 3e-5):
        fail(f"RGBTrainBlend differs from the plain chain: {r['chain']}")
    del leaves, rgb_k, t_k, rows, per, want
    if timed:
        r["K7"]["ms"] = cuda_ms(k7, 10)[0]
        r["K7"]["plain_ms"] = cuda_ms(k7_plain, 1)[0]
        r["K7"]["library_ms"] = None
        # Reads the pack once, g_sorted over the covered entries, the tile
        # ranges and 36 B of each distinct Gaussian; writes [covered, 9].
        r["K7"]["bound_ms"], r["K7"]["bound_by"] = bound(
            x["pack"].numel() * 4 + x["covered"] * 4 + gx * gy * 8
            + x["distinct"] * 36 + x["covered"] * 9 * 4,
            x["n_eval"] * BLEND_ALPHA_FLOPS
            + x["n_inc"] * RGB_BWD_INCLUDE_FLOPS)
    return r


def rgb_checks_reduced(dev) -> dict:
    """Phase 8: K7 and RGBTrainBlend on a reduced scene (50k Gaussians,
    272x480, SH degree 3, one camera)."""
    model, images = rgb_scene(50_000, 272, 480, 1, 1, dev)
    cam = train_cameras("rgbsmall", (0.0,), 272, 480, images)[0]
    x = rgb_step_inputs(model, cam, 1 << 20, dev)
    r = check_rgb_kernels(x, dev, timed=False)
    log(f"reduced geometry step: K1 {r['K1']['mismatches']} entries differ "
        f"from the plain version; K2 rgb max |kernel - plain| "
        f"{r['K2']['max_abs_err']!r}; K7 {r['K7']['max_abs_err']!r} "
        f"({r['K7']['rel_err']!r} of the largest); RGBTrainBlend vs the "
        f"plain chain {r['chain']}")
    torch.cuda.synchronize()
    return r


def rgb_path(dev) -> dict:
    """Phase 9: train_rgb at full width with densification and the launch
    counts of the run; then, on one step's own inputs, K1, K2, K7 and the
    RGBTrainBlend chain against their plain versions, K7 timed, the step's
    stages, and the opacity reset."""
    t0 = time.perf_counter()
    model, images = rgb_scene(RGB_N, TRAIN_H, TRAIN_W, len(TRAIN_YAW_DEG), 0,
                              dev)
    cams = train_cameras("rgb", TRAIN_YAW_DEG, TRAIN_H, TRAIN_W, images)
    n0 = int(model.num_live)
    log(f"geometry scene: {RGB_N} Gaussians (create_from_pcd), SH degree "
        f"3, {TRAIN_H}x{TRAIN_W}, {len(cams)} cameras "
        f"({time.perf_counter() - t0:.1f} s)")
    opt = OptimizationParams(argparse.ArgumentParser())
    for k, v in RGB_DENSIFY.items():
        setattr(opt, k, v)
    max_entries = 2 ** 21
    step_ms, metrics_log, densify_ms = [], [], []
    clock = [None]
    run_densify = trainer.run_densify

    def timed_densify(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_densify(*a, **kw)
        torch.cuda.synchronize()
        densify_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def on_iteration(it, m, _opt, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - clock[0]) * 1e3)
        clock[0] = now
        metrics_log.append(dict(
            iteration=it, loss=float(metrics["loss"]),
            total_entries=int(metrics["total_entries"]),
            num_visible=int(metrics["num_visible"]),
            num_live=int(m.num_live), capacity=m.capacity))

    trainer.run_densify = timed_densify
    try:
        zero_counts(RGB_WRAPPERS)
        clock[0] = time.perf_counter()
        model, optimizer, logs = trainer.train_rgb(
            model, cams, opt, RGB_EXTENT, iterations=RGB_ITERS, seed=0,
            max_entries=max_entries, on_iteration=on_iteration, device=dev)
    finally:
        trainer.run_densify = run_densify
    launches = read_counts(RGB_WRAPPERS)
    losses_ = logs.losses
    tot = [m["total_entries"] for m in metrics_log]
    dens_it = {e[0] for e in logs.events if e[1] == "densify"}
    plain_steps = [t for m, t in zip(metrics_log, step_ms)
                   if m["iteration"] not in dens_it]
    log(f"geometry training: {RGB_ITERS} steps, median "
        f"{statistics.median(plain_steps):.3f} ms a step without a densify "
        f"event (host clock + synchronize); loss first {losses_[0]!r} last "
        f"{losses_[-1]!r}; events {logs.events}; densify rounds "
        f"{densify_ms} ms; capacity {n0} -> {model.capacity}; "
        f"total_entries {max(tot)} against max_entries {max_entries}")
    log(f"launches on the geometry path ({RGB_ITERS} steps): {launches}")
    if not all(v == RGB_ITERS for v in launches.values()):
        fail(f"a kernel of the geometry path missed a step: {launches}")
    if not all(math.isfinite(v) for v in losses_):
        fail(f"non-finite geometry loss: {losses_}")
    if not statistics.mean(losses_[-4:]) < statistics.mean(losses_[:4]):
        fail(f"the geometry loss did not fall: {losses_}")
    if max(tot) >= max_entries:
        fail("the geometry run saturated its entry budget")
    if not (len(dens_it) == 3 and max(e[2] for e in logs.events) > n0
            and model.capacity > n0):
        fail(f"no densify event grew the model: {logs.events}, capacity "
             f"{model.capacity}")

    x = rgb_step_inputs(model, cams[0], max_entries, dev)
    rows = check_rgb_kernels(x, dev, timed=True)
    stages = rgb_stages(model, optimizer, cams[0], x, dev)

    # The opacity reset, once, on the grown model (after the timing: it
    # empties most entries).
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = trainer.apply_opacity_reset(model, optimizer)
    torch.cuda.synchronize()
    reset_ms = (time.perf_counter() - t) * 1e3
    top = float(model.get_opacity().detach().max())
    state = optimizer.state[model.opacity]
    if not (top <= 0.01 + 1e-6 and not state["exp_avg"].any()
            and not state["exp_avg_sq"].any()):
        fail(f"opacity reset: max opacity {top}, moments not zeroed")
    log(f"opacity reset: {reset_ms:.3f} ms, max opacity after {top!r}")
    for k, v in rows.items():
        log(f"geometry {k}: " + ", ".join(f"{a} {b!r}" for a, b in v.items()))
    log("geometry stages (ms, each alone): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    return dict(step_ms_median=statistics.median(plain_steps),
                step_ms=step_ms, densify_ms=densify_ms,
                opacity_reset_ms=reset_ms, losses=losses_,
                events=logs.events, metrics=metrics_log,
                capacity=[n0, model.capacity], max_entries=max_entries,
                launches=launches, kernels=rows, stage_ms=stages,
                step_entries=dict(total=x["total"], covered=x["covered"],
                                  pairs_evaluated=x["n_eval"],
                                  pairs_included=x["n_inc"],
                                  distinct_gaussians=x["distinct"]))


def rgb_stages(model, optimizer, cam, x, dev) -> dict:
    """The geometry step's stages, each timed alone on one step's inputs."""
    s = x["settings"]
    gx, gy = s.grid_x, s.grid_y
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    view, projm, campos = (T(cam.world_view_transform),
                           T(cam.full_proj_transform), T(cam.camera_center))
    params = trainer.rgb_params(model)

    def pre():
        return projection.preprocess(
            model.xyz, model.get_scaling(), model.get_rotation(),
            model.get_features(), None, view, projm, campos, s.tanfovx,
            s.tanfovy, s.image_width, s.image_height, s.sh_degree,
            opacities=x["op"])

    gen = torch.Generator(device=dev).manual_seed(3)
    n = model.capacity
    g_xy, g_conic, g_rgb = (torch.randn(shape, device=dev, generator=gen)
                            for shape in ((n, 2), (n, 3), (n, 3)))

    def pre_fwd_bwd():
        p = pre()
        torch.autograd.backward([p.xy, p.conic, p.rgb], [g_xy, g_conic, g_rgb])

    proj_d = projection.detach(pre())
    zero3 = torch.zeros(3, device=dev)
    img = rasterize_tiles.tiles_to_image(x["rgb_t"], gx, gy, s.image_height,
                                         s.image_width)
    gt = T(cam.image)

    def loss_fwd_bwd():
        leaf = img.detach().requires_grad_(True)
        loss = 0.8 * losses.l1_loss(leaf, gt) + 0.2 * (
            1.0 - losses.ssim(leaf, gt))
        loss.backward()

    dgrad = rgb_train.rgb_grads(x["g"], x["start"], x["count"], x["geom"],
                                x["pack"], gx, gy)
    for p in params.values():
        p.grad = torch.randn(p.shape, device=dev, generator=gen)
    stages = {
        "preprocess forward (SH 3, EWA)": cuda_ms(pre, 5)[0],
        "K1 + sort": cuda_ms(lambda: sorted_binning(s, proj_d, x["op"]),
                             5)[0],
        "K2 rgb": cuda_ms(lambda: blend.blend_tiles(
            x["g"], x["start"], x["count"], x["geom"], zero3, gx, gy), 5)[0],
        "loss (L1 + SSIM, forward and backward)": cuda_ms(loss_fwd_bwd,
                                                          5)[0],
        "K7 geometry backward": cuda_ms(lambda: rgb_train.rgb_grads(
            x["g"], x["start"], x["count"], x["geom"], x["pack"], gx, gy),
            5)[0],
        "index_add_ to Gaussians": cuda_ms(
            lambda: rgb_train.reduce_to_gaussians(dgrad, x["g"], n), 5)[0],
        "preprocess backward": cuda_ms(pre_fwd_bwd, 5)[0]
        - cuda_ms(pre, 5)[0],
        "Adam (six groups)": cuda_ms(optimizer.step, 5)[0],
    }
    return stages


# ------------------------------------------- phase 10: bf16 (fast16) serving

def bf16_variants(s: RasterizeSettings) -> dict:
    """The serving default's rows (precision="bf16", feat_bf16) on phase
    4's budgets: exact, and capped as bench.py:738-759 sets it."""
    b = s._replace(precision="bf16", feat_bf16=True, assemble=False)
    return {"exact": b, "capped": b._replace(
        tile_budget=CAPPED["tile_budget"], tile_budget_cap=CAPPED["cap"],
        tile_budget_subdiv=CAPPED["subdiv"], cull_alpha=1.0 / 255.0)}


def relevancy_mask(raw, nrm2) -> torch.Tensor:
    """test_capped_relevancy_iou's mask: cosine sim > 0.18 per level and
    prompt (all prompts, negatives included)."""
    t, p, lpq = raw.shape
    sim = raw.reshape(t * p, L, -1) / (torch.sqrt(torch.clamp(
        nrm2.reshape(t * p, L), min=0.0))[..., None] + 1e-10)
    return sim > 0.18


def fast16_inputs(model, s, view, pm, dev) -> dict:
    """What fast16 K2 gets in a frame of settings `s` (the calls of
    rasterize: preprocess, binning, the fast16 rows)."""
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    with torch.no_grad():
        op = model.get_opacity()[:, 0].contiguous()
        proj = projection.preprocess(
            model.xyz, model.get_scaling(), model.get_rotation(),
            model.get_features(), None, T(view), T(pm),
            torch.zeros(3, device=dev), s.tanfovx, s.tanfovy,
            s.image_width, s.image_height, 0, opacities=op,
            cull_alpha=s.cull_alpha)
        if s.tile_budget > 0:
            g, start, count, _, _ = capped_binning(s, proj, op, True)
            n_blend = int(count.sum())
            ids = g.reshape(-1, s.tile_budget_cap)
            ids = ids[torch.arange(s.tile_budget_cap, device=dev)[None, :]
                      < count[:, None]]
        else:
            g, start, count, _, _ = sorted_binning(s, proj, op)
            n_blend = int(count.sum())
            ids = g[:n_blend]
        rows = blend.pack_fast16_rows(proj.xy, proj.conic, op, proj.rgb,
                                      model.quick_weights,
                                      model.quick_indices)
    return dict(g=g, start=start, count=count, rows=rows,
                bg=torch.zeros(3, device=dev), covered=n_blend,
                distinct=int(torch.unique(ids).numel()))


def check_fast16(x, s, timed: bool, cells: bool = False) -> dict:
    """fast16 K2 (level bands on, as the frames run it) on one frame's
    inputs against its plain version: outputs before the bf16 rounding
    (feat_bf16 off) atol 3e-5; the bf16 tiles and rounded colour within
    one bf16 ulp of the plain version's, final T atol 3e-5. With `cells`
    (bf16 cell math) the same limits, and the map further from the f32
    cells' map than CELLS_EFFECT times 3e-5. With `timed`, its time
    (feat_bf16 on, as served), the plain version's and its bound for this
    data."""
    gx, gy = s.grid_x, s.grid_y
    args = (x["g"], x["start"], x["count"], x["rows"], x["bg"], gx)
    out = blend.blend_tiles_fast16(*args, gy, L * TOPK, L * K, False,
                                   cells_bf16=cells)
    ref = blend.blend_tiles_fast16_plain(*args, L * TOPK, L * K, False,
                                         cells_bf16=cells)
    err = max_diff(zip(out, ref))
    r = dict(f32_out_err=err)
    if cells:
        f32 = blend.blend_tiles_fast16(*args, gy, L * TOPK, L * K, False)
        r["vs_f32_cells"] = float((out[1] - f32[1]).abs().max())
        del f32
    if not (err <= 3e-5 and (not cells
                             or r["vs_f32_cells"] > CELLS_EFFECT * 3e-5)):
        fail(f"fast16 K2 (f32 outputs, cells {cells}) differs from its "
             f"plain version by {err} (atol 3e-5), or the cells from the "
             f"f32 cells by only {r.get('vs_f32_cells')}")
    del out, ref
    stats = torch.zeros(2, dtype=torch.int64, device=x["g"].device)
    k2 = lambda: blend.blend_tiles_fast16(  # noqa: E731
        *args, gy, L * TOPK, L * K, True, cells_bf16=cells)
    k2_plain = lambda: blend.blend_tiles_fast16_plain(  # noqa: E731
        *args, L * TOPK, L * K, True, cells_bf16=cells)
    out = blend.blend_tiles_fast16(*args, gy, L * TOPK, L * K, True,
                                   stats=stats, cells_bf16=cells)
    ref = k2_plain()
    ulps = 0.0
    for a, b in zip(out[:2], ref[:2]):
        a, b = a.float(), b.float()
        ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp(min=1e-30)))
                         - 7)
        ulps = max(ulps, float(((a - b).abs() / ulp).max()))
    t_err = float((out[2] - ref[2]).abs().max())
    if not (ulps <= 1.0 and t_err <= 3e-5):
        fail(f"fast16 K2 (bf16 outputs, cells {cells}) differs from its "
             f"plain version: {ulps} ulp, final T {t_err}")
    n_eval, n_inc = check_counts(
        f"fast16 K2 (cells {cells})", stats, x["g"], x["start"], x["count"],
        blend.unpack_fast16_rows(x["rows"], L * TOPK)[0], gx, cells)
    r.update(max_abs_err=max(err, t_err), bf16_ulps=ulps, t_err=t_err,
             pairs_evaluated=n_eval, pairs_included=n_inc,
             distinct_gaussians=x["distinct"])
    del out, ref
    if timed:
        n_tiles = gx * gy
        r["ms"] = cuda_ms(k2, 10)[0]
        r["plain_ms"] = cuda_ms(k2_plain, 1)[0]
        r["library_ms"] = None
        # g ids of the blended entries, tile ranges, a 64-byte row a
        # distinct Gaussian; rgb and T in f32, the map in bf16.
        r["bound_ms"], r["bound_by"] = bound(
            x["covered"] * 4 + n_tiles * 8 + x["distinct"] * 64
            + n_tiles * 256 * (4 * 4 + L * K * 2),
            r["pairs_evaluated"] * BLEND_ALPHA_FLOPS
            + r["pairs_included"] * BLEND_INCLUDE_FLOPS)
    return r


def check_query_bf16(wm, phi, gram, timed: bool) -> dict:
    """bf16 K3 on a frame's bf16 map against its plain version on the same
    rounded operands (rtol/atol 1e-5); with `timed`, its time, the plain
    version's, its bound (the bf16 map read once; the products at the bf16
    tensor-core rate) and the bf16 einsum pair."""
    out = query.query_map_tiles_bf16(wm, phi, gram)
    ref = query.query_map_tiles_bf16_plain(wm, phi, gram)
    r = dict(max_abs_err=max_diff(zip(out, ref)))
    if not all(torch.allclose(a, b, rtol=1e-5, atol=1e-5)
               for a, b in zip(out, ref)):
        fail(f"bf16 K3 differs from its plain version by "
             f"{r['max_abs_err']} (rtol/atol 1e-5)")
    if timed:
        pq = phi.shape[2]
        q = wm.shape[0] * 256
        wm3 = wm.reshape(-1, L, K)
        phi_b, gram_b = phi.to(torch.bfloat16), gram.to(torch.bfloat16)

        def einsum_pair():
            torch.einsum("qlk,lkp->qlp", wm3, phi_b)
            torch.einsum("qlk,lkm,qlm->ql", wm3, gram_b, wm3)

        r["ms"] = cuda_ms(lambda: query.query_map_tiles_bf16(wm, phi, gram),
                          20)[0]
        r["plain_ms"] = cuda_ms(
            lambda: query.query_map_tiles_bf16_plain(wm, phi, gram), 5)[0]
        r["library_ms"] = cuda_ms(einsum_pair, 5)[0]
        r["bound_ms"], r["bound_by"] = bound(
            q * L * K * 2 + (L * K * pq + L * K * K) * 4
            + q * L * (pq + 1) * 4,
            q * L * 2 * K * (K + pq + 1), BF16_TENSOR_FLOPS)
    return r


def bf16_serving(model, clip, consts, plans, f32_frames, dev) -> dict:
    """Phase 10: the serving default (fast16 rows, bf16 map), exact and
    capped, at both loads: counted frames, then fast16 K2 and bf16 K3 on
    the frames' own inputs against their plain versions and timed."""
    zero_counts(BF16_WRAPPERS)
    runs = {}
    for name, (s, view, pm) in plans.items():
        for variant, sv in bf16_variants(s).items():
            host_ms, stages = [], []
            for _ in range(FRAMES):
                events = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, relev = frame(model, sv, view, pm, clip, consts, dev,
                                   events)
                torch.cuda.synchronize()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                stages.append({b[0]: a[1].elapsed_time(b[1])
                               for a, b in zip(events, events[1:])})
            runs[name, variant] = (sv, out, relev, host_ms, stages)
    launches = read_counts(BF16_WRAPPERS)
    n_frames = FRAMES * len(runs)
    log(f"launches on the bf16 serving path ({n_frames} frames): {launches}")
    if not all(v == n_frames for v in launches.values()):
        fail(f"a kernel of the bf16 serving path missed a frame: {launches}")

    results = {}
    for name, (s, view, pm) in plans.items():
        res = {}
        for variant in ("exact", "capped"):
            sv, out, relev, host_ms, stages = runs[name, variant]
            wm = out.language_feature_weight_map
            tot, live = int(out.total_entries), int(out.live_total)
            checks = {
                "total < max_entries": tot < sv.max_entries,
                "bf16 map": wm.dtype == torch.bfloat16
                and tuple(wm.shape) == (s.grid_x * s.grid_y, 256, L * K),
                "finite": all(bool(torch.isfinite(t).all()) for t in (
                    out.render, wm, out.final_transmittance, relev)),
            }
            bad = [k for k, v in checks.items() if not v]
            if bad:
                fail(f"{name} bf16 {variant}: checks failed: {bad}")
            res[variant] = dict(
                frame_ms_median=statistics.median(host_ms), frame_ms=host_ms,
                stage_ms_median={k: statistics.median(st[k] for st in stages)
                                 for k in stages[0]},
                total_entries=tot, live_total=live,
                max_tile_count=int(out.max_tile_count))
        if not res["capped"]["live_total"] < res["exact"]["live_total"]:
            fail(f"{name}: the capped kept total is not below the exact "
                 f"live total: {res}")
        masks = [relevancy_mask(*query.query_map_tiles(
            runs[name, v][1].language_feature_weight_map, *consts))
            for v in ("exact", "capped")]
        union = int((masks[0] | masks[1]).sum())
        res["relevancy_iou"] = int((masks[0] & masks[1]).sum()) / max(union,
                                                                      1)
        del masks
        for variant in ("exact", "capped"):
            sv, out = runs[name, variant][:2]
            x = fast16_inputs(model, sv, view, pm, dev)
            res[variant]["K2f16"] = check_fast16(x, sv,
                                                 timed=variant == "exact")
            res[variant]["K3bf16"] = check_query_bf16(
                out.language_feature_weight_map, *consts,
                timed=variant == "exact")
            del x
        results[name] = res
        e, c = res["exact"], res["capped"]
        log(f"{name} bf16: frame median exact {e['frame_ms_median']:.3f} ms, "
            f"capped {c['frame_ms_median']:.3f} ms (f32 frame "
            f"{f32_frames[name]:.3f} ms); live {e['live_total']} exact, "
            f"kept {c['live_total']} capped, saturation bound "
            f"{c['max_tile_count']}; relevancy IoU capped vs exact "
            f"{res['relevancy_iou']!r}")
        for variant in ("exact", "capped"):
            log(f"{name} bf16 {variant} stages (median ms): " + ", ".join(
                f"{k} {v:.3f}" for k, v in
                res[variant]["stage_ms_median"].items()))
            for k in ("K2f16", "K3bf16"):
                log(f"{name} bf16 {variant} {k}: " + ", ".join(
                    f"{a} {b!r}" for a, b in res[variant][k].items()))
        for key in [k for k in runs if k[0] == name]:
            del runs[key]
        torch.cuda.empty_cache()
    return dict(loads=results, launches=launches)


# -------------------------------------- phase 12: the fused-query serving frame

def query_frame(model, s, view, pm, clip, consts, dev, events=None):
    """rasterize_quick_query (K1, K2q) and the relevancy tail."""
    out = rasterize_quick_query(
        s, model.xyz, model.get_opacity(), view, pm, np.zeros(3, np.float32),
        np.zeros(3, np.float32), scales=model.get_scaling(),
        rotations=model.get_rotation(), shs=model.get_features(),
        quick_weights=model.quick_weights, quick_indices=model.quick_indices,
        phi=consts[0], gram=consts[1], quick_channels=L * K, device=dev,
        stage_events=events)
    relev = clip.relevancy_from_query(
        out[1], out[2], s.grid_x, s.grid_y, s.image_height, s.image_width,
        stage_events=events)
    return out, relev


def query_bound(x, n_tiles, pq, n_eval, n_inc) -> tuple[float, str]:
    """K2q's bound: g, the ranges, a 64-byte row a distinct Gaussian, the
    constants, and rgb, raw, nrm2 and T written, against the pair work at
    the f32 rate plus the epilogue's 2 L K (PQ + K + 1) products a pixel at
    the bf16 tensor rate (bf16 K3's count)."""
    nbytes = (x["covered"] * 4 + n_tiles * 8 + x["distinct"] * 64
              + (L * K * pq + L * K * K) * 4
              + n_tiles * 256 * (3 + L * pq + L + 1) * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ((n_eval * BLEND_ALPHA_FLOPS + n_inc * BLEND_INCLUDE_FLOPS)
             / F32_FLOPS + n_tiles * 256 * 2 * L * K * (pq + K + 1)
             / BF16_TENSOR_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_query_kernel(x, s, consts, timed: bool) -> dict:
    """K2q on one frame's inputs against its plain version (rgb and T atol
    3e-5, raw and nrm2 1e-5 of their largest) and against the unfused
    routes on the same inputs: fast16 K2 with f32 tiles then f32 K3 (5e-3
    of the largest: the fused products take bf16 operands); fast16 K2 with
    bf16 tiles then bf16 K3 (the same bf16 products: raw 1e-5 of its
    largest; nrm2 5e-3, its last factor is the f32 weight). With `timed`,
    K2q beside its plain version, its bound and the unfused pair."""
    gx, gy = s.grid_x, s.grid_y
    phi, gram = consts
    pq = phi.shape[2]
    seg = (x["g"], x["start"], x["count"], x["rows"], x["bg"])
    stats = torch.zeros(2, dtype=torch.int64, device=x["g"].device)
    out = blend.blend_tiles_query(*seg, gx, gy, L * TOPK, phi, gram,
                                  stats=stats)
    ref = blend.blend_tiles_query_plain(*seg, gx, L * TOPK, phi, gram)
    check_counts("K2q", stats, *seg[:3],
                 blend.unpack_fast16_rows(x["rows"], L * TOPK)[0], gx)
    r = dict(max_abs_err=max_diff(zip(out, ref)),
             rgb_t_err=max(float((out[i] - ref[i]).abs().max())
                           for i in (0, 3)),
             raw_nrm2_rel=max(normalized_err(out[i], ref[i])[1]
                              for i in (1, 2)),
             pairs_evaluated=int(stats[0]), pairs_included=int(stats[1]),
             distinct_gaussians=x["distinct"])
    del ref
    if not (r["rgb_t_err"] <= 3e-5 and r["raw_nrm2_rel"] <= 1e-5):
        fail(f"K2q differs from its plain version: {r}")
    _, wm32, _ = blend.blend_tiles_fast16(*seg, gx, gy, L * TOPK, L * K,
                                          False)
    unf = query.query_map_tiles(wm32, phi, gram)
    del wm32
    _, wm16, _ = blend.blend_tiles_fast16(*seg, gx, gy, L * TOPK, L * K,
                                          True)
    unb = query.query_map_tiles(wm16, phi, gram)
    del wm16
    r["vs_unfused_f32"] = [normalized_err(out[i], unf[i - 1])[1]
                           for i in (1, 2)]
    r["vs_unfused_bf16"] = [normalized_err(out[i], unb[i - 1])[1]
                            for i in (1, 2)]
    del unf, unb, out
    if not (max(r["vs_unfused_f32"]) <= 5e-3
            and r["vs_unfused_bf16"][0] <= 1e-5
            and r["vs_unfused_bf16"][1] <= 5e-3):
        fail(f"K2q differs from the unfused route: {r}")
    if timed:
        k2q = lambda: blend.blend_tiles_query(  # noqa: E731
            *seg, gx, gy, L * TOPK, phi, gram)

        def unfused_pair():
            wm = blend.blend_tiles_fast16(*seg, gx, gy, L * TOPK, L * K,
                                          True)[1]
            query.query_map_tiles_bf16(wm, phi, gram)

        r["ms"] = cuda_ms(k2q, 10)[0]
        r["plain_ms"] = cuda_ms(lambda: blend.blend_tiles_query_plain(
            *seg, gx, L * TOPK, phi, gram), 1)[0]
        r["library_ms"] = None
        r["unfused_pair_ms"] = cuda_ms(unfused_pair, 10)[0]
        r["bound_ms"], r["bound_by"] = query_bound(
            x, gx * gy, pq, r["pairs_evaluated"], r["pairs_included"])
    return r


def fused_query_serving(model, clip, consts, plans, bf16_frames,
                        dev) -> dict:
    """Phase 12: rasterize_quick_query at both loads, exact and capped
    (phase 10's variants, assemble off): counted frames, then K2q on each
    variant's own inputs against its plain version and the unfused routes,
    timed beside its bound and the unfused pair."""
    zero_counts(SERVE_WRAPPERS)
    runs = {}
    for name, (s, view, pm) in plans.items():
        for variant, sv in bf16_variants(s).items():
            host_ms, stages = [], []
            for _ in range(FRAMES):
                events = []
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out, relev = query_frame(model, sv, view, pm, clip, consts,
                                         dev, events)
                torch.cuda.synchronize()
                host_ms.append((time.perf_counter() - t0) * 1e3)
                stages.append({b[0]: a[1].elapsed_time(b[1])
                               for a, b in zip(events, events[1:])})
            runs[name, variant] = (sv, out, relev, host_ms, stages)
    launches = read_counts(SERVE_WRAPPERS)
    n_frames = FRAMES * len(runs)
    log(f"launches on the fused-query serving path ({n_frames} frames): "
        f"{launches}")
    if not (launches["K1"] == launches["K2q"] == n_frames
            and launches["K2"] == launches["K2f16"] == 0
            and launches["K3"] == launches["K3bf16"] == 0):
        fail(f"the fused-query path's launches are off: {launches}")

    results = {}
    pq = consts[0].shape[2]
    for name, (s, view, pm) in plans.items():
        res = {}
        for variant in ("exact", "capped"):
            sv, out, relev, host_ms, stages = runs.pop((name, variant))
            rgb, raw, nrm2, final_t, _radii, tot, live = out
            n_tiles = sv.grid_x * sv.grid_y
            checks = {
                "total < max_entries": int(tot) < sv.max_entries,
                "live_total <= live_entries": variant == "capped"
                or int(live) <= sv.live_entries,
                "shapes": tuple(raw.shape) == (n_tiles, 256, L * pq)
                and tuple(nrm2.shape) == (n_tiles, 256, L),
                "finite": all(bool(torch.isfinite(t).all()) for t in (
                    rgb, raw, nrm2, final_t, relev)),
            }
            bad = [k for k, v in checks.items() if not v]
            if bad:
                fail(f"{name} fused {variant}: checks failed: {bad}")
            del out, relev
            x = fast16_inputs(model, sv, view, pm, dev)
            kq = check_query_kernel(x, sv, consts, timed=variant == "exact")
            del x
            res[variant] = dict(
                frame_ms_median=statistics.median(host_ms), frame_ms=host_ms,
                stage_ms_median={k: statistics.median(st[k] for st in stages)
                                 for k in stages[0]},
                total_entries=int(tot), live_total=int(live), K2q=kq)
            log(f"{name} fused {variant}: frame median "
                f"{res[variant]['frame_ms_median']:.3f} ms (phase 10 "
                f"unfused {bf16_frames[name][variant]:.3f}); stages "
                + ", ".join(f"{k} {v:.3f}" for k, v in
                            res[variant]["stage_ms_median"].items()))
            log(f"{name} fused {variant} K2q: " + ", ".join(
                f"{a} {b!r}" for a, b in kq.items()))
            torch.cuda.empty_cache()
        results[name] = res
    return dict(loads=results, launches=launches)


def frame_traces(model, clip, consts, plans, dev) -> dict:
    """Phase 12 (end): torch.profiler over one 1080p frame of the serving
    default (fast16 rows, bf16 map, exact) and one fused-query frame: the
    device's busy share (its summed kernel time over the frame's host
    clock; "not measured" where key_averages shows no device time) and the
    five largest kernels by device time."""
    s, view, pm = plans["1080p"]
    sv = bf16_variants(s)["exact"]
    res = {}
    for key, fn in (
            ("fast16 frame", lambda: frame(model, sv, view, pm, clip, consts,
                                           dev)),
            ("fused frame", lambda: query_frame(model, sv, view, pm, clip,
                                                consts, dev))):
        with torch.no_grad():
            d = device_split(fn, top=5)
        d["busy_share"] = (d["device_total"] / d["wall"]
                           if d["device_total"] > 0 else "not measured")
        res[key] = d
        log(f"1080p {key} trace: device busy {d['busy_share']} "
            f"({d['device_total']:.1f} us of kernels over a "
            f"{d['wall']:.1f} us frame, {d['launches']} launches); largest: "
            + "; ".join(f"{k} {v:.1f} us" for k, v in d["kernels"].items()))
    return res


# ------------------------------ phase 13: the render server, temporal reuse

def yaw_c2w(px: float, width: int, fovx: float) -> np.ndarray:
    """bench.py's serving path (treq_at): the identity camera turned by
    `px` pixels of yaw at this width."""
    th = px / (0.5 * width / math.tan(fovx / 2))
    c, s_ = math.cos(th), math.sin(th)
    c2w = np.eye(4)
    c2w[:3, :3] = np.array([[c, 0, s_], [0, 1, 0], [-s_, 0, c]])
    return c2w


def serve_request(c2w, w, h, fovy, heatmap=True, threshold=-10.0) -> dict:
    return {"c2w": c2w.tolist(), "width": w, "height": h, "fov_y": fovy,
            "prompt": "object", "show_heatmap": heatmap,
            "threshold": threshold}


def timed_request(backend, req) -> tuple[np.ndarray, float, float]:
    """(u8 frame, dispatch ms, finalize ms), host clock, the card idle
    before."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = backend.dispatch_request(req)
    t1 = time.perf_counter()
    img = backend.finalize_frame(pending, as_uint8=True)
    t2 = time.perf_counter()
    return img, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of fn() followed by synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def serve_path(backend, w, h, fovx, fovy, max_entries) -> dict:
    """The counted run of phase 13: SERVE_REQUESTS requests on the 1 px a
    frame path after a warm-up, the rebin / steady split against what the
    policy implies from the last bin pose, the launch counts, and each
    request's dispatch and finalize times."""
    for px in (0.0, 0.2):               # warm-up: a rebin, then a steady
        backend.finalize_frame(backend.dispatch_request(serve_request(
            yaw_c2w(px, w, fovx), w, h, fovy)), as_uint8=True)
    # The policy's decisions on the path, on the poses as the server reads
    # them (f32), from the warm-up's bin pose.
    bin_c2w, want = np.float32(yaw_c2w(0.0, w, fovx)), []
    for i in range(SERVE_REQUESTS):
        c2w = np.float32(yaw_c2w(i + 1.0, w, fovx))
        if temporal.motion_px(bin_c2w, c2w, w, fovx, 2.0) <= REUSE_PX:
            want.append("steady")
        else:
            want.append("rebin")
            bin_c2w = c2w
    zero_counts(SERVE_WRAPPERS)
    times = {"steady": [], "rebin": []}
    dispatch = {"steady": [], "rebin": []}
    got, saturated, served = [], False, None
    for i in range(SERVE_REQUESTS):
        before = dict(backend.cache_hits)
        c2w = yaw_c2w(i + 1.0, w, fovx)
        img, d_ms, f_ms = timed_request(backend, serve_request(c2w, w, h,
                                                               fovy))
        kind = "steady" if backend.cache_hits["steady"] > before["steady"] \
            else "rebin"
        if kind == "steady":
            motion = temporal.motion_px(backend._tc_c2w, np.float32(c2w), w,
                                        fovx, 2.0)
            if served is None or motion >= served[0]:
                served = (motion, backend._tc_cache, c2w)
        got.append(kind)
        times[kind].append(d_ms + f_ms)
        dispatch[kind].append(d_ms)
        entry = backend._pose_entry
        if not (img.dtype == np.uint8 and img.shape == (h, w, 3)
                and bool(torch.isfinite(entry["rgb"]).all())
                and bool(torch.isfinite(entry["wm16"].float()).all())):
            fail(f"server request {i}: bad frame")
        saturated |= int(backend._tc_cache.total_entries) >= max_entries
    launches = read_counts(SERVE_WRAPPERS)
    counters = {k: got.count(k) for k in ("steady", "rebin")}
    log(f"server: {SERVE_REQUESTS} requests on a 1 px yaw path, counters "
        f"{counters}, rebins at requests "
        f"{[i + 1 for i, k in enumerate(got) if k == 'rebin']} (the "
        f"{REUSE_PX} px policy's: "
        f"{[i + 1 for i, k in enumerate(want) if k == 'rebin']}); launches "
        f"{launches}")
    if got != want or not (0 < counters["rebin"] < SERVE_REQUESTS):
        fail("the server's rebin / steady sequence is not the policy's")
    if not (launches["K1"] == counters["rebin"]
            and launches["K2f16"] == SERVE_REQUESTS
            and launches["K2"] == launches["K2q"] == 0
            and launches["K3"] == launches["K3bf16"] == 0):
        fail(f"the server's launches are off: {launches}")
    if saturated:
        fail("a server bin frame saturated its entry budget")
    return served, dict(counters=counters, launches=launches,
                steady_ms_median=statistics.median(times["steady"]),
                rebin_ms_median=statistics.median(times["rebin"]),
                steady_dispatch_ms_median=statistics.median(
                    dispatch["steady"]),
                rebin_dispatch_ms_median=statistics.median(dispatch["rebin"]),
                steady_ms=times["steady"], rebin_ms=times["rebin"])


def check_steady_fast16(backend, served, w, h, fovy) -> dict:
    """fast16 K2 as the server launches it on a steady frame (the frozen
    binning's per-entry rows with their pose words rebuilt, g = slot id,
    tile t's window at t*cap, kept frozen), held against its plain
    version as phase 10 holds it (check_fast16): at the counted run's
    steady request with the most motion from its bin pose, on that
    request's own cache, and on the same cache after a teleport forward to
    the kept entries' median depth, where about half of them fall behind
    the near plane (opacity 0, their conic possibly non-finite)."""
    motion, cache, c2w = served
    cap = backend.tile_budget_cap
    g = torch.arange(cache.rows.shape[0], dtype=torch.int32,
                     device=cache.rows.device)
    live = (torch.arange(cap, device=g.device)[None, :]
            < cache.kept[:, None]).reshape(-1)
    covered = int(cache.kept.sum())
    teleport = np.eye(4)
    teleport[2, 3] = float(cache.geo[live, 2].median())
    r = {}
    for key, pose in (("served", c2w), ("teleport", teleport)):
        settings, view, full, _ = backend._camera(np.float32(pose), w, h,
                                                  fovy)
        rows = temporal.steady_entry_geom(settings, cache, view, full)
        # Each slot has a row of its own: the distinct rows are the kept.
        x = dict(g=g, start=g[::cap].contiguous(), count=cache.kept,
                 rows=rows, bg=backend.background, covered=covered,
                 distinct=covered)
        r[key] = check_fast16(x, settings, timed=False)
        vz = torch.as_tensor(view[:, 2], device=g.device)
        depth = cache.geo[:, :3] @ vz[:3] + vz[3]
        r[key]["masked_entries"] = int(((depth <= 0.2) & live).sum())
        del rows, x
    r["served"]["motion_px"] = motion
    log(f"server fast16 K2 on steady frames vs plain: {r}")
    if not 0 < r["teleport"]["masked_entries"] < covered:
        fail("the teleported steady frame masked no entry, or all")
    return r


def bin_pose_check(model, settings, view, full, campos, dev):
    """The steady frame at its bin pose against a fresh capped render with
    cov3d_precomp (the same EWA formulation), and the bin-cache build
    timed. Returns (the cache, the comparison, the build's median ms)."""
    m, zero3 = model, np.zeros(3, np.float32)
    h, w = settings.image_height, settings.image_width
    bin_args = (settings, m.xyz, m.get_opacity(), view, full, campos)
    bin_kw = dict(scales=m.get_scaling(), rotations=m.get_rotation(),
                  shs=m.get_features(), quick_weights=m.quick_weights,
                  quick_indices=m.quick_indices, device=dev)
    build_ms = host_ms(lambda: temporal.quick_bin_cache(*bin_args, **bin_kw),
                       FRAMES)
    cache = temporal.quick_bin_cache(*bin_args, **bin_kw)
    steady = temporal.rasterize_quick_steady(settings, cache, view, full,
                                             zero3, L * K, L * TOPK)
    with torch.no_grad():
        cov3d = temporal.build_cov3d(m.get_scaling(), m.get_rotation())
        op = m.get_opacity()[:, 0]
        proj_c = projection.preprocess(
            m.xyz, None, None, m.get_features(), None, *(torch.as_tensor(
                a, device=dev) for a in (view, full, campos)),
            settings.tanfovx, settings.tanfovy, w, h, 0, opacities=op,
            cull_alpha=settings.cull_alpha, cov3d_precomp=cov3d)
        kept_f = capped_binning(settings, proj_c, op, True)[2]
        fresh = rasterize(settings._replace(assemble=False), m.xyz,
                          m.get_opacity(), view, full, campos, zero3,
                          cov3d_precomp=cov3d, shs=m.get_features(),
                          quick_weights=m.quick_weights,
                          quick_indices=m.quick_indices,
                          quick_channels=L * K, device=dev)
    rgb_s = rasterize_tiles.tiles_to_image(steady[0], settings.grid_x,
                                           settings.grid_y, h, w)
    r = dict(kept_tiles_differing=int((kept_f != cache.kept).sum()),
             kept_total=[int(cache.live_total), int(fresh.live_total)],
             rgb_err=float((rgb_s - fresh.rgb).abs().max()),
             feat_err=float((steady[1].float()
                             - fresh.feature_map.float()).abs().max()))
    log(f"server bin pose: steady frame vs fresh capped render with "
        f"cov3d_precomp {r} (kept equal, rgb atol 1e-6)")
    return cache, r, build_ms


def fused_steady_curve(model, clip, consts, backend, cache, settings, fovx,
                       dev):
    """Fused steady frames (K2q) against fresh fused frames at 1-16 px
    (bench.py:924-975): relevancy max and mean error and the mask IoU
    (> 0.5), printed, not gated; K2q held against its plain version on the
    2 px frame (rgb and T atol 3e-5, raw and nrm2 1e-5 of the largest)."""
    m, zero3 = model, np.zeros(3, np.float32)
    h, w = settings.image_height, settings.image_width
    gx, gy, cap = settings.grid_x, settings.grid_y, CAPPED["cap"]
    curve, kq = [], None
    for px in (1.0, 2.0, 4.0, 8.0, 16.0):
        _s, v, p, _c = backend._camera(
            yaw_c2w(px, w, fovx).astype(np.float32), w, h,
            math.radians(60))
        st = temporal.rasterize_quick_steady(settings, cache, v, p, zero3,
                                             L * K, L * TOPK, *consts)
        fr = rasterize_quick_query(
            settings, m.xyz, m.get_opacity(), v, p, zero3, zero3,
            scales=m.get_scaling(), rotations=m.get_rotation(),
            shs=m.get_features(), quick_weights=m.quick_weights,
            quick_indices=m.quick_indices, phi=consts[0], gram=consts[1],
            quick_channels=L * K, device=dev)
        r_s, r_f = (clip.relevancy_from_query(a, b, gx, gy, h, w)
                    for a, b in ((st[1], st[2]), (fr[1], fr[2])))
        m_s, m_f = r_s > 0.5, r_f > 0.5
        d = (r_s - r_f).abs()
        curve.append(dict(px=px, max_err=float(d.max()),
                          mean_err=float(d.mean()),
                          mask_iou=int((m_s & m_f).sum())
                          / max(int((m_s | m_f).sum()), 1)))
        if px == 2.0:
            g = torch.arange(gx * gy * cap, dtype=torch.int32, device=dev)
            ref = blend.blend_tiles_query_plain(
                g, g[::cap].contiguous(), cache.kept,
                temporal.steady_entry_geom(settings, cache, v, p),
                torch.zeros(3, device=dev), gx, L * TOPK, *consts)
            kq = dict(max_abs_err=max_diff(zip(st, ref)),
                      rgb_t_err=max(float((st[i] - ref[i]).abs().max())
                                    for i in (0, 3)),
                      raw_nrm2_rel=max(normalized_err(st[i], ref[i])[1]
                                       for i in (1, 2)))
            if not (kq["rgb_t_err"] <= 3e-5 and kq["raw_nrm2_rel"] <= 1e-5):
                fail(f"K2q on a steady frame differs from its plain "
                     f"version: {kq}")
            del ref
        del st, fr, r_s, r_f
    log("server relevancy, fused steady vs fresh: " + "; ".join(
        f"{c['px']} px max {c['max_err']:.4f} mean {c['mean_err']:.6f} "
        f"IoU {c['mask_iou']:.4f}" for c in curve))
    log(f"server K2q on a steady frame vs plain: {kq}")
    return curve, kq


def serving_server(model, clip, consts, plans, dev) -> dict:
    """Phase 13: BackendRenderer at 986x728 with temporal reuse on a 1 px a
    frame yaw path (bench.py:1073-1119); a pose-cache hit, a capped request
    without reuse and an rgb request timed; the steady frame at its bin
    pose against the fresh cov3d render; the steady request's parts timed
    alone; the fused steady frames' relevancy against fresh ones."""
    s_load = plans[SERVE_LOAD][0]
    h, w = s_load.image_height, s_load.image_width
    fovy = math.radians(60)
    fovx = 2 * math.atan(math.tan(fovy / 2) * w / h)
    common = dict(clip_model=OpenCLIPNetwork("hash", device=dev),
                  max_entries=s_load.max_entries, compose="device",
                  tile_budget=CAPPED["tile_budget"],
                  tile_budget_cap=CAPPED["cap"],
                  tile_budget_subdiv=CAPPED["subdiv"], device=dev)
    backend = BackendRenderer(model, temporal_reuse_px=REUSE_PX,
                              reuse_zref=2.0, **common)
    served, r = serve_path(backend, w, h, fovx, fovy, s_load.max_entries)
    r["K2f16_steady"] = check_steady_fast16(backend, served, w, h, fovy)
    del served

    last = yaw_c2w(float(SERVE_REQUESTS), w, fovx)
    hits = backend.cache_hits["pose"]
    r["pose_hit_ms_median"] = statistics.median(
        sum(timed_request(backend, serve_request(last, w, h, fovy,
                                                 threshold=t))[1:])
        for t in (-9.0, -8.0, -7.0, -6.0, -5.0))
    if backend.cache_hits["pose"] != hits + 5:
        fail(f"pose-cache hits {backend.cache_hits}")
    plain = BackendRenderer(model, pose_cache=False, **common)
    for key, start, heatmap in (("capped_frame", 100.0, True),
                                ("rgb_request", 200.0, False)):
        ms = [sum(timed_request(plain, serve_request(
            yaw_c2w(start + i, w, fovx), w, h, fovy, heatmap))[1:])
            for i in range(FRAMES + 1)]
        r[f"{key}_ms_median"] = statistics.median(ms[1:])  # after a warm-up
    del plain

    settings, view, full, campos = backend._camera(
        yaw_c2w(0.0, w, fovx).astype(np.float32), w, h, fovy)
    settings = settings._replace(assemble=False)
    cache, r["bin_pose"], r["bin_cache_ms_median"] = bin_pose_check(
        model, settings, view, full, campos, dev)
    # The steady request's two parts alone, 2 px from the bin pose.
    _s, v, p, _c = backend._camera(yaw_c2w(2.0, w, fovx).astype(np.float32),
                                   w, h, fovy)
    zero3 = np.zeros(3, np.float32)
    r["steady_blend_ms_median"] = host_ms(
        lambda: temporal.rasterize_quick_steady(settings, cache, v, p, zero3,
                                                L * K, L * TOPK), FRAMES)
    entry = backend._pose_entry
    phi_s, gram_s = backend._phi_gram("object")
    r["query_compose_ms_median"] = host_ms(
        lambda: backend._query_compose(entry["rgb"], entry["wm16"], phi_s,
                                       gram_s, -10.0, L, K, True), FRAMES)
    r["fused_steady_ms_median"] = host_ms(
        lambda: temporal.rasterize_quick_steady(settings, cache, v, p, zero3,
                                                L * K, L * TOPK, *consts),
        FRAMES)
    r["relevancy_vs_fresh"], r["K2q_steady"] = fused_steady_curve(
        model, clip, consts, backend, cache, settings, fovx, dev)
    log("server times (median ms, host clock): " + ", ".join(
        f"{k} {v:.3f}" for k, v in r.items() if k.endswith("ms_median")))
    bp = r["bin_pose"]
    if not (bp["kept_tiles_differing"] == 0 and bp["rgb_err"] <= 1e-6
            and bp["kept_total"][0] == bp["kept_total"][1]):
        fail(f"the steady frame at its bin pose is not the fresh cov3d "
             f"render: {bp}")
    return r


# ------------------------------------------ phase 11: capped feature training

def capped_step_inputs(model, cam, max_entries: int, dev) -> dict:
    """What the kernels of one capped training step get: the windows, the
    K2 forward on them (with its pair counts), the map's Gram-loss
    cotangent from K6b, for K5 and the stages timed alone."""
    s = make_settings(cam, 0, 1.0, max_entries,
                      tile_budget=CAPPED["tile_budget"],
                      tile_budget_cap=CAPPED["cap"],
                      tile_budget_subdiv=CAPPED["subdiv"])
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    gx, gy = s.grid_x, s.grid_y
    hw = s.image_height * s.image_width
    with torch.no_grad():
        qw, qi = model.get_weights_and_indices(TRAIN_TOPK)
        qw, qi = qw.contiguous(), qi.int().contiguous()
        op = model.get_opacity()[:, 0].contiguous()
        proj = projection.preprocess(
            model.xyz, model.get_scaling(), model.get_rotation(),
            model.get_features(), None, T(cam.world_view_transform),
            T(cam.full_proj_transform), T(cam.camera_center), s.tanfovx,
            s.tanfovy, s.image_width, s.image_height, 0, opacities=op)
        g, start, kept, sat, total = capped_binning(s, proj, op, False)
        geom = blend.pack_gaussian_state(proj.xy, proj.conic, op, proj.rgb)
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        _, wmap, _ = blend.blend_tiles(g, start, kept, geom,
                                       torch.zeros(3, device=dev), gx, gy, qw,
                                       qi, TRAIN_K, stats=stats)
        check_counts("K2 f32 (capped step)", stats, g, start, kept, geom, gx)
        table, seg = cam.get_language_feature_compact(GT_DIR, 1)
        rhs, gfull = gram.prep(model.codebooks, T(table), 0)
        cot = gram.gram_tiles_bwd(gram.seg_to_tiles(T(seg), gx, gy), wmap,
                                  rhs, gfull, 0, TRAIN_K, 1e-8, 1.0 / hw,
                                  torch.ones((), device=dev))[0]
        slots = torch.arange(s.tile_budget_cap, device=dev)[None, :] \
            < kept[:, None]
    return dict(settings=s, g=g, start=start, kept=kept, geom=geom, qw=qw,
                qi=qi, cot=cot, total=int(total), kept_total=int(kept.sum()),
                saturation_bound=int(sat.max()), n_eval=int(stats[0]),
                n_inc=int(stats[1]),
                distinct=int(torch.unique(g.reshape(kept.shape[0], -1)[
                    slots]).numel()))


def check_k5(x, timed: bool) -> dict:
    """K5 on one step's windows and cotangent against its plain version
    (1e-5 of its largest output: sums of 256 pixels in another order);
    with `timed`, its time, the plain version's and its bound."""
    s = x["settings"]
    gx, gy, cap = s.grid_x, s.grid_y, s.tile_budget_cap
    args = (x["g"], x["kept"], x["geom"], x["qi"], x["cot"])
    k5 = lambda: train.feature_grads_topk(*args, gx, gy, cap)  # noqa: E731
    k5_plain = lambda: train.feature_grads_topk_plain(  # noqa: E731
        *args, gx, cap)
    out, ref = k5(), k5_plain()
    err = normalized_err(out, ref)
    r = dict(max_abs_err=err[0], rel_err=err[1])
    if not err[1] <= 1e-5:
        fail(f"K5 differs from its plain version by {err} (abs, relative)")
    del out, ref
    if timed:
        n_tiles, topk = gx * gy, x["qi"].shape[1]
        r["ms"] = cuda_ms(k5, 10)[0]
        r["plain_ms"] = cuda_ms(k5_plain, 1)[0]
        r["library_ms"] = None
        # The cotangent, the blended slots' ids, the kept counts, 24 B of
        # state and the top-k indices of each distinct Gaussian; the
        # [T*cap, topk] rows written.
        r["bound_ms"], r["bound_by"] = bound(
            x["cot"].numel() * 4 + x["kept_total"] * 4 + n_tiles * 4
            + x["distinct"] * (24 + topk * 4) + n_tiles * cap * topk * 4,
            x["n_eval"] * BLEND_ALPHA_FLOPS + x["n_inc"] * (3 + 2 * topk))
    return r


def capped_train_path(dev) -> dict:
    """Phase 11: K5 against its plain version on a reduced scene, then
    train_features on the capped route (scripts/train.sh's defaults:
    tile_budget 1e-6, cap 128) at phase 7's full width, the launch counts
    of the run, K5 on one step's own inputs, timed, and the step's stages
    alone."""
    small, rng = train_scene(50_000, 1, dev)
    write_gt(rng, "csmall", 1, 272, 480)
    cam = train_cameras("csmall", (0.0,), 272, 480)[0]
    reduced = check_k5(capped_step_inputs(small, cam, 1 << 20, dev), False)
    log(f"reduced K5: max |kernel - plain| {reduced['max_abs_err']!r} "
        f"({reduced['rel_err']!r} of the largest)")
    del small

    model, rng = train_scene(TRAIN_N, 0, dev)
    write_gt(rng, "cap", len(TRAIN_YAW_DEG), TRAIN_H, TRAIN_W)
    cams = train_cameras("cap", TRAIN_YAW_DEG, TRAIN_H, TRAIN_W)
    opt = type("Opt", (), {"language_feature_lr": 0.0025})()
    max_entries = 2 ** 21
    step_ms, metrics_log = [], []
    clock = [None]

    def on_iteration(_it, _model, _opt, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - clock[0]) * 1e3)
        clock[0] = now
        metrics_log.append({k: float(v) for k, v in metrics.items()})

    zero_counts(CAPPED_WRAPPERS)
    clock[0] = time.perf_counter()
    model, optimizer, logs = trainer.train_features(
        model, cams, opt, GT_DIR, 1, iterations=TRAIN_ITERS, seed=0,
        max_entries=max_entries, tile_budget=CAPPED["tile_budget"],
        tile_budget_cap=CAPPED["cap"], tile_budget_subdiv=CAPPED["subdiv"],
        feature_cache={}, on_iteration=on_iteration, device=dev)
    launches = read_counts(CAPPED_WRAPPERS)
    losses_ = logs.losses
    budgets = list(logs.exp_budget.values())
    tot = [int(m["total_entries"]) for m in metrics_log]
    kept = [int(m["live_total"]) for m in metrics_log]
    log(f"capped training: {TRAIN_ITERS} steps, median "
        f"{statistics.median(step_ms):.3f} ms a step (host clock + "
        f"synchronize); loss first {losses_[0]!r} last {losses_[-1]!r}; "
        f"kept {min(kept)}..{max(kept)}; total_entries {min(tot)}.."
        f"{max(tot)} against the expansion budget {budgets} (first step "
        f"at {max_entries})")
    log(f"launches on the capped training path ({TRAIN_ITERS} steps): "
        f"{launches}")
    once = ("K5", "K6b")
    if not (all(launches[k] == TRAIN_ITERS for k in once)
            and all(launches[k] >= TRAIN_ITERS for k in ("K1", "K2", "K6a"))
            and launches["K4"] == 0):
        fail(f"the capped training path's launches are off: {launches}")
    if not all(math.isfinite(v) for v in losses_):
        fail(f"non-finite capped training loss: {losses_}")
    if not statistics.mean(losses_[-4:]) < statistics.mean(losses_[:4]):
        fail(f"the capped training loss did not fall: {losses_}")
    if not (len(budgets) == 1 and tot[0] < max_entries
            and max(tot[1:]) < budgets[0]
            and launches["K1"] == TRAIN_ITERS):
        fail(f"the expansion budget overflowed or was redone: {budgets}, "
             f"totals {tot}, launches {launches}")

    x = capped_step_inputs(model, cams[0], budgets[0], dev)
    rows = check_k5(x, timed=True)
    s = x["settings"]._replace(assemble=False)
    c = cams[0]
    zero3 = np.zeros(3, np.float32)
    with torch.no_grad():
        fwd = lambda: render(  # noqa: E731
            s, model, c.world_view_transform, c.full_proj_transform,
            c.camera_center, zero3, include_feature=True, topk=TRAIN_TOPK,
            device=dev)
        dproj = train.feature_grads_topk(x["g"], x["kept"], x["geom"],
                                         x["qi"], x["cot"], s.grid_x,
                                         s.grid_y, s.tile_budget_cap)
        g_long = x["g"].long()
        red = lambda: torch.zeros(x["qi"].shape, device=dev).index_add_(  # noqa: E731
            0, g_long, dproj)
        gin = gram_inputs(model, c, s, dev)
        stages = {
            "render forward (preprocess, K1, sort, windows + budget, K2, "
            "top-k)": cuda_ms(fwd, 5)[0],
            "K6a gram forward": cuda_ms(lambda: gram.gram_tiles_fwd(
                *gin[:4]), 10)[0],
            "K6b gram backward": cuda_ms(lambda: gram.gram_tiles_bwd(
                *gin), 10)[0],
            "K5 feature backward": rows["ms"],
            "index_add_": cuda_ms(red, 5)[0],
            "Adam step": cuda_ms(optimizer.step, 5)[0]}
    del dproj
    log("capped training K5: " + ", ".join(f"{a} {b!r}"
                                           for a, b in rows.items()))
    log("capped training stages (ms, each alone): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    return dict(step_ms_median=statistics.median(step_ms), step_ms=step_ms,
                losses=losses_, exp_budget=budgets, total_entries=tot,
                kept_total=kept, max_entries=max_entries, launches=launches,
                reduced=reduced, kernels={"K5": rows}, stage_ms=stages,
                step_entries=dict(total=x["total"], kept=x["kept_total"],
                                  saturation_bound=x["saturation_bound"],
                                  pairs_evaluated=x["n_eval"],
                                  pairs_included=x["n_inc"],
                                  distinct_gaussians=x["distinct"]))


def gram_inputs(model, cam, s, dev):
    """(seg tiles, the step's map, rhs, G, layer, K, eps, 1/HW, upstream)
    for K6a/K6b on one capped step's map."""
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    out = render(s, model, cam.world_view_transform, cam.full_proj_transform,
                 cam.camera_center, np.zeros(3, np.float32),
                 include_feature=True, topk=TRAIN_TOPK, device=dev)
    table, seg = cam.get_language_feature_compact(GT_DIR, 1)
    rhs, gfull = gram.prep(model.codebooks.detach(), T(table), 0)
    return (gram.seg_to_tiles(T(seg), s.grid_x, s.grid_y),
            out.language_feature_weight_map.contiguous(), rhs, gfull, 0,
            TRAIN_K, 1e-8, 1.0 / (s.image_height * s.image_width),
            torch.ones((), device=dev))


# ------------------------------------------------ phase 14: dense features

def dense_inputs(model, s, view, pm, campos, dev) -> dict:
    """What K2's dense mode gets in a dense frame of settings `s` (the
    calls of rasterize(features=...) with impl="pallas": the preprocess,
    the sort binning without the live clamp, the f32 state)."""
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    with torch.no_grad():
        op = model.get_opacity()[:, 0].contiguous()
        proj = projection.preprocess(
            model.xyz, model.get_scaling(), model.get_rotation(),
            model.get_features(), None, T(view), T(pm), T(campos),
            s.tanfovx, s.tanfovy, s.image_width, s.image_height,
            model.active_sh_degree, opacities=op)
        g, start, count, total, _ = sorted_binning(
            s._replace(live_entries=0), proj, op)
        geom = blend.pack_gaussian_state(proj.xy, proj.conic, op, proj.rgb)
    covered = int(count.sum())
    return dict(g=g, start=start, count=count, geom=geom, total=int(total),
                covered=covered, bg=torch.zeros(3, device=dev),
                distinct=int(torch.unique(g[:covered]).numel()))


def image_to_tiles(img, grid_x: int, grid_y: int):
    """[C, H, W] -> [T, 256, C] row-major tiles, zero past the image (the
    inverse of rasterize_tiles.tiles_to_image: the map's cotangent as K4
    reads it)."""
    c, h, w = img.shape
    pad = torch.zeros((c, grid_y * 16, grid_x * 16), device=img.device)
    pad[:, :h, :w] = img
    return pad.reshape(c, grid_y, 16, grid_x, 16).permute(
        1, 3, 2, 4, 0).reshape(grid_x * grid_y, 256, c).contiguous()


def dense_bound(x, n_tiles: int, d: int, n_eval: int,
                n_inc: int) -> tuple[float, str]:
    """K2 dense: g ids and ranges, a distinct Gaussian's 36-byte state and
    D-float row, rgb, the [T, 256, D] map and T written; 14 operations an
    evaluated pair, 3 + 2 (3 + D) an included one."""
    return bound(x["covered"] * 4 + n_tiles * 8
                 + x["distinct"] * (36 + 4 * d)
                 + n_tiles * 256 * (3 + d + 1) * 4,
                 n_eval * BLEND_ALPHA_FLOPS + n_inc * (3 + 2 * (3 + d)))


def check_dense(x, gx: int, gy: int, feats, timed: bool) -> dict:
    """K2 dense against its plain version (atol 3e-5); with `timed`, its
    time, the plain version's and its bound."""
    args = (x["g"], x["start"], x["count"], x["geom"])
    stats = torch.zeros(2, dtype=torch.int64, device=feats.device)
    out = blend.blend_tiles_dense(*args, feats, x["bg"], gx, gy, stats=stats)
    ref = blend.blend_tiles_dense_plain(*args, feats, x["bg"], gx)
    check_counts(f"K2 dense (D = {feats.shape[1]})", stats, *args, gx)
    r = dict(max_abs_err=max_diff(zip(out, ref)), channels=feats.shape[1],
             groups=len(blend.dense_groups(feats.shape[1])),
             pairs_evaluated=int(stats[0]), pairs_included=int(stats[1]))
    del out, ref
    if not r["max_abs_err"] <= 3e-5:
        fail(f"K2 dense differs from its plain version: {r}")
    if timed:
        r["ms"] = cuda_ms(lambda: blend.blend_tiles_dense(
            *args, feats, x["bg"], gx, gy), 10)[0]
        r["plain_ms"] = cuda_ms(lambda: blend.blend_tiles_dense_plain(
            *args, feats, x["bg"], gx), 1)[0]
        r["library_ms"] = None
        r["bound_ms"], r["bound_by"] = dense_bound(
            x, gx * gy, feats.shape[1], r["pairs_evaluated"],
            r["pairs_included"])
    return r


def check_k4_dense(x, gx: int, gy: int, cot, timed: bool) -> dict:
    """K4 on a dense cotangent against its plain version (1e-5 of the
    largest); with `timed`, its time, the plain version's and its bound
    (counted as phase 7 counts K4's)."""
    args = (x["g"], x["start"], x["count"], x["geom"], cot)
    out = train.feature_grads(*args, gx, gy)
    ref = train.feature_grads_plain(*args, gx)
    err = normalized_err(out, ref)
    r = dict(max_abs_err=err[0], rel_err=err[1], channels=cot.shape[2])
    del out, ref
    if not err[1] <= 1e-5:
        fail(f"K4 at C = {cot.shape[2]} differs from its plain version: {r}")
    if timed:
        c = cot.shape[2]
        stats = torch.zeros(2, dtype=torch.int64, device=cot.device)
        blend.blend_tiles(x["g"], x["start"], x["count"], x["geom"],
                          x["bg"], gx, gy, stats=stats)
        r["ms"] = cuda_ms(lambda: train.feature_grads(*args, gx, gy), 10)[0]
        r["plain_ms"] = cuda_ms(lambda: train.feature_grads_plain(*args, gx),
                                1)[0]
        r["library_ms"] = None
        r["bound_ms"], r["bound_by"] = bound(
            x["covered"] * 4 + gx * gy * 8 + x["distinct"] * 24
            + cot.numel() * 4 + x["covered"] * c * 4,
            int(stats[0]) * BLEND_ALPHA_FLOPS + int(stats[1]) * (3 + 2 * c),
            F32_TENSOR_FLOPS)
    return r


def dense_path(dev) -> dict:
    """Phase 14 (a) and (b): K2 dense and K4 on a reduced scene, then the
    dense feature step on phase 7's training scene."""
    gen = torch.Generator(device=dev).manual_seed(14)
    model, _ = train_scene(50_000, 1, dev)
    cam = train_cameras("small", (0.0,), 272, 480)[0]
    s = make_settings(cam, 0, 1.0, 1 << 20, impl="pallas")
    x = dense_inputs(model, s, cam.world_view_transform,
                     cam.full_proj_transform, cam.camera_center, dev)
    reduced = {}
    for d in DENSE_WIDTHS:
        feats = torch.rand(model.xyz.shape[0], d, device=dev, generator=gen)
        reduced[d] = check_dense(x, s.grid_x, s.grid_y, feats, timed=False)
    cot = torch.randn(s.grid_x * s.grid_y, 256, 192, device=dev,
                      generator=gen)
    reduced["K4 C=192"] = check_k4_dense(x, s.grid_x, s.grid_y, cot, False)
    log(f"reduced dense: {reduced}")
    del model, x, cot

    model, _ = train_scene(TRAIN_N, 0, dev)
    model.language_logits.requires_grad_(True)
    cams = train_cameras("cam", TRAIN_YAW_DEG, TRAIN_H, TRAIN_W)
    max_entries = 2 ** 21
    settings = [make_settings(c, 0, 1.0, max_entries, impl="pallas")
                for c in cams]
    cots = [torch.randn(TRAIN_K, TRAIN_H, TRAIN_W, device=dev, generator=gen)
            for _ in cams]
    zero3 = np.zeros(3, np.float32)

    def step(i, features=None):
        c, si = cams[i % len(cams)], settings[i % len(cams)]
        w = model.get_render_weights(TRAIN_TOPK) if features is None \
            else features
        out = rasterize(si, model.xyz, model.get_opacity(),
                        c.world_view_transform, c.full_proj_transform,
                        c.camera_center, zero3, scales=model.get_scaling(),
                        rotations=model.get_rotation(),
                        shs=model.get_features(), features=w, device=dev)
        loss = (out.feature_map * cots[i % len(cams)]).sum()
        loss.backward()
        return out, loss

    step_ms, totals = [], []
    zero_counts(DENSE_WRAPPERS)
    for i in range(TRAIN_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, loss = step(i)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        totals.append(int(out.total_entries))
        if not (math.isfinite(float(loss.detach()))
                and bool(torch.isfinite(model.language_logits.grad).all())):
            fail(f"dense step {i}: non-finite loss or gradient")
        model.language_logits.grad = None
    launches = read_counts(DENSE_WRAPPERS)
    log(f"dense feature steps: {TRAIN_ITERS} at {TRAIN_H}x{TRAIN_W}, median "
        f"{statistics.median(step_ms):.3f} ms (host clock); launches "
        f"{launches}; total_entries {max(totals)} of {max_entries}")
    if not all(v == TRAIN_ITERS for v in launches.values()):
        fail(f"a kernel of the dense step missed a step: {launches}")
    if max(totals) >= max_entries:
        fail("a dense step saturated its entry budget")

    # One step's d(features), projected on each Gaussian's top-4, against
    # the quick_train route's d(quick_weights) on the same camera.
    w = model.get_render_weights(TRAIN_TOPK).detach().requires_grad_(True)
    step(0, w)
    qw, qi = model.get_weights_and_indices(TRAIN_TOPK)
    qw = qw.detach().contiguous().requires_grad_(True)
    c = cams[0]
    out_q = rasterize(settings[0], model.xyz, model.get_opacity(),
                      c.world_view_transform, c.full_proj_transform,
                      c.camera_center, zero3, scales=model.get_scaling(),
                      rotations=model.get_rotation(),
                      shs=model.get_features(), quick_weights=qw,
                      quick_indices=qi, quick_channels=TRAIN_K,
                      quick_train=True, device=dev)
    (out_q.feature_map * cots[0]).sum().backward()
    vs_quick = normalized_err(w.grad.gather(1, qi.long()), qw.grad)
    log(f"dense d(features) on the top-4 vs quick_train d(quick_weights): "
        f"{vs_quick}")
    if not vs_quick[1] <= 1e-5:
        fail(f"the dense gradient differs from the quick route's: "
             f"{vs_quick}")
    x = dense_inputs(model, settings[0], c.world_view_transform,
                     c.full_proj_transform, c.camera_center, dev)
    k2 = check_dense(x, settings[0].grid_x, settings[0].grid_y,
                     w.detach().contiguous(), timed=True)
    k4 = check_k4_dense(x, settings[0].grid_x, settings[0].grid_y,
                        image_to_tiles(cots[0], settings[0].grid_x,
                                       settings[0].grid_y), timed=True)
    for k, v in (("K2dense", k2), ("K4", k4)):
        log(f"dense step {k}: " + ", ".join(f"{a} {b!r}"
                                            for a, b in v.items()))
    return dict(reduced=reduced, step_ms_median=statistics.median(step_ms),
                step_ms=step_ms, launches=launches, vs_quick=vs_quick,
                kernels={"K2dense": k2, "K4": k4})


def dense_serving(model, plans, dev) -> dict:
    """Phase 14 (c): at both loads, the dense map of the scattered quick
    pairs (D = 192, impl="pallas") against the f32 quick frame (1e-5),
    and K2 dense timed at D = 192 beside its bound."""
    zero3 = np.zeros(3, np.float32)
    n = model.xyz.shape[0]
    feats = torch.zeros(n, L * K, device=dev).scatter_add_(
        1, model.quick_indices.long(), model.quick_weights)
    res = {}
    for name, (s, view, pm) in plans.items():
        common = dict(scales=model.get_scaling(),
                      rotations=model.get_rotation(),
                      shs=model.get_features(), device=dev)
        with torch.no_grad():
            sa = s._replace(assemble=True)
            dense = rasterize(sa._replace(impl="pallas"), model.xyz,
                              model.get_opacity(), view, pm, zero3, zero3,
                              features=feats, **common)
            quick = rasterize(sa, model.xyz, model.get_opacity(), view, pm,
                              zero3, zero3, quick_weights=model.quick_weights,
                              quick_indices=model.quick_indices,
                              quick_channels=L * K, **common)
            err = max_diff([(dense.feature_map, quick.feature_map),
                            (dense.rgb, quick.rgb),
                            (dense.final_transmittance,
                             quick.final_transmittance)])
        del dense, quick
        if not err <= 1e-5:
            fail(f"{name}: the dense map of the quick pairs differs from the "
                 f"quick frame by {err}")
        x = dense_inputs(model, s, view, pm, zero3, dev)
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        args = (x["g"], x["start"], x["count"], x["geom"], feats, x["bg"],
                s.grid_x, s.grid_y)
        blend.blend_tiles_dense(*args, stats=stats)
        check_counts(f"{name} K2 dense (D = 192)", stats, *args[:4],
                     s.grid_x)
        r = dict(vs_quick_frame=err, ms=cuda_ms(
            lambda: blend.blend_tiles_dense(*args), 3)[0])
        r["bound_ms"], r["bound_by"] = dense_bound(
            x, s.grid_x * s.grid_y, L * K, int(stats[0]), int(stats[1]))
        res[name] = r
        log(f"{name} dense D=192: {r}")
        del x
        torch.cuda.empty_cache()
    return res


# --------------------------------------------- phase 15: bf16 cell math

def check_query_cells(x, s, consts, timed: bool) -> dict:
    """K2q with bf16 cells against its plain version at K2q's limits (rgb
    and T atol 3e-5, raw and nrm2 1e-5 of their largest), and its raw
    scores further from the f32 cells' than CELLS_EFFECT times 1e-5 of
    their largest; with `timed`, its time, the plain version's and its
    bound (K2q's)."""
    gx, gy = s.grid_x, s.grid_y
    phi, gram = consts
    seg = (x["g"], x["start"], x["count"], x["rows"], x["bg"])
    stats = torch.zeros(2, dtype=torch.int64, device=x["g"].device)
    out = blend.blend_tiles_query(*seg, gx, gy, L * TOPK, phi, gram,
                                  stats=stats, cells_bf16=True)
    ref = blend.blend_tiles_query_plain(*seg, gx, L * TOPK, phi, gram,
                                        cells_bf16=True)
    f32 = blend.blend_tiles_query(*seg, gx, gy, L * TOPK, phi, gram)
    check_counts("K2q (bf16 cells)", stats, *seg[:3],
                 blend.unpack_fast16_rows(x["rows"], L * TOPK)[0], gx, True)
    r = dict(max_abs_err=max_diff(zip(out, ref)),
             rgb_t_err=max(float((out[i] - ref[i]).abs().max())
                           for i in (0, 3)),
             raw_nrm2_rel=max(normalized_err(out[i], ref[i])[1]
                              for i in (1, 2)),
             vs_f32_cells_rel=normalized_err(out[1], f32[1])[1],
             pairs_evaluated=int(stats[0]), pairs_included=int(stats[1]))
    del out, ref, f32
    if not (r["rgb_t_err"] <= 3e-5 and r["raw_nrm2_rel"] <= 1e-5
            and r["vs_f32_cells_rel"] > CELLS_EFFECT * 1e-5):
        fail(f"K2q with bf16 cells differs from its plain version, or its "
             f"scores too little from the f32 cells': {r}")
    if timed:
        r["ms"] = cuda_ms(lambda: blend.blend_tiles_query(
            *seg, gx, gy, L * TOPK, phi, gram, cells_bf16=True), 10)[0]
        r["plain_ms"] = cuda_ms(lambda: blend.blend_tiles_query_plain(
            *seg, gx, L * TOPK, phi, gram, cells_bf16=True), 1)[0]
        r["library_ms"] = None
        r["bound_ms"], r["bound_by"] = query_bound(
            x, gx * gy, phi.shape[2], r["pairs_evaluated"],
            r["pairs_included"])
    return r


def bf16_cells_serving(model, clip, consts, plans, ref_ms, dev) -> dict:
    """Phase 15: phase 10's and 12's frames with bf16_cells at both loads,
    exact and capped (counted), each against its f32-cell frame
    (relevancy mask IoU >= 0.95), fast16 K2 and K2q with bf16 cells
    against their plain versions on each frame's own inputs, and one
    server run of phase 13's requests with bf16_cells."""
    zero_counts(CELLS_WRAPPERS)
    runs = {}
    for name, (s, view, pm) in plans.items():
        for variant, sv in bf16_variants(s).items():
            sc = sv._replace(bf16_cells=True)
            times = {"frame": [], "fused": []}
            for _ in range(FRAMES):
                for kind, fn in (("frame", frame), ("fused", query_frame)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out, _ = fn(model, sc, view, pm, clip, consts, dev)
                    torch.cuda.synchronize()
                    times[kind].append((time.perf_counter() - t0) * 1e3)
                    if kind == "frame":
                        wm = out.language_feature_weight_map
                    else:
                        fused = out
            runs[name, variant] = (sv, wm, fused[1], fused[2], times)
    launches = read_counts(CELLS_WRAPPERS)
    n = FRAMES * len(runs)
    log(f"launches on the bf16-cell frames ({n} + {n} fused): {launches}")
    if not (launches["K1"] == 2 * n and launches["K2f16"] == n
            and launches["K2q"] == n and launches["K3bf16"] == n):
        fail(f"a kernel of the bf16-cell frames missed a frame: {launches}")

    results = {}
    for (name, variant), (sv, wm, raw, nrm2, times) in runs.items():
        s, view, pm = plans[name]
        with torch.no_grad():
            ref_out, _ = frame(model, sv, view, pm, clip, consts, dev)
            ref_q, _ = query_frame(model, sv, view, pm, clip, consts, dev)
        masks = [relevancy_mask(*query.query_map_tiles(m, *consts))
                 for m in (wm, ref_out.language_feature_weight_map)]
        fmasks = [relevancy_mask(raw, nrm2), relevancy_mask(ref_q[1],
                                                            ref_q[2])]
        iou = [int((a & b).sum()) / int((a | b).sum())
               if bool((a | b).any()) else 1.0 for a, b in (masks, fmasks)]
        del masks, fmasks, ref_out, ref_q
        if not (min(iou) >= 0.95 and bool(torch.isfinite(
                wm.float()).all()) and bool(torch.isfinite(raw).all())):
            fail(f"{name} {variant}: bf16 cells IoU {iou} below 0.95 or "
                 "non-finite outputs")
        x = fast16_inputs(model, sv, view, pm, dev)
        timed = variant == "exact"
        r = dict(frame_ms_median=statistics.median(times["frame"]),
                 fused_ms_median=statistics.median(times["fused"]),
                 f32_cells_frame_ms=ref_ms[name][variant],
                 relevancy_iou=iou[0], fused_relevancy_iou=iou[1],
                 K2f16cells=check_fast16(x, sv, timed, cells=True),
                 K2qcells=check_query_cells(x, sv, consts, timed))
        results.setdefault(name, {})[variant] = r
        del x
        log(f"{name} bf16 cells {variant}: frame "
            f"{r['frame_ms_median']:.3f} ms, fused {r['fused_ms_median']:.3f}"
            f" ms (f32 cells: {r['f32_cells_frame_ms']}); IoU {iou}")
        for k in ("K2f16cells", "K2qcells"):
            log(f"{name} bf16 cells {variant} {k}: " + ", ".join(
                f"{a} {b!r}" for a, b in r[k].items()))
        torch.cuda.empty_cache()
    del runs

    s_load = plans[SERVE_LOAD][0]
    h, w = s_load.image_height, s_load.image_width
    fovy = math.radians(60)
    fovx = 2 * math.atan(math.tan(fovy / 2) * w / h)
    backend = BackendRenderer(
        model, clip_model=OpenCLIPNetwork("hash", device=dev),
        max_entries=s_load.max_entries, compose="device", bf16_cells=True,
        tile_budget=CAPPED["tile_budget"], tile_budget_cap=CAPPED["cap"],
        tile_budget_subdiv=CAPPED["subdiv"], temporal_reuse_px=REUSE_PX,
        reuse_zref=2.0, device=dev)
    _, server = serve_path(backend, w, h, fovx, fovy, s_load.max_entries)
    log(f"server with bf16 cells: steady {server['steady_ms_median']:.3f} "
        f"ms, rebin {server['rebin_ms_median']:.3f} ms")
    del backend
    return dict(loads=results, launches=launches, server=server)


# ------------------------------------------- phase 16: the cascade binner

def sort_segments(proj, op, gx: int, gy: int, max_entries: int):
    """The sort path's binning without the live clamp: K1, the key sort."""
    tile, depth, gauss, _ = expand.expand_entries(proj, op, gx, gy,
                                                  max_entries)
    return expand.sort_entries(tile, depth, gauss, gx * gy)


def segments_differ(casc, sort) -> int:
    """Entries whose Gaussian differs between two binnings' segments,
    tile by tile (counts must be equal first)."""
    (g, start, count), (g_s, start_s, count_s) = casc, sort
    if not torch.equal(count, count_s):
        return -1
    n = int(count.sum())
    tile = torch.repeat_interleave(
        torch.arange(count.shape[0], device=g.device), count.long())
    rank = torch.arange(n, device=g.device) - (torch.cumsum(
        count, 0) - count).long()[tile]
    return int((g[start.long()[tile] + rank]
                != g_s[start_s.long()[tile] + rank]).sum())


def k8_bound(proj, total: int, n_tiles: int) -> tuple[float, str]:
    """K8: the depth sort (a key read, an id written a Gaussian), level 0
    (ids, rects and tile counts read, an id a tile row written), level 1
    (those ids read, rect and cull state gathered, the kept ids written),
    the ranges; the cull's operations once a (Gaussian, tile) pair of the
    rects."""
    n = proj.xy.shape[0]
    alive = proj.tiles_touched > 0
    rows = int((proj.rect_max[:, 1] - proj.rect_min[:, 1])[alive].sum())
    pairs = int(proj.tiles_touched.sum())
    return bound(n * 8 + n * 24 + rows * 4 + rows * (4 + 16 + 24)
                 + total * 4 + n_tiles * 8, pairs * CULL_FLOPS)


def check_k8(proj, op, gx: int, gy: int, budget: int, timed: bool) -> dict:
    """K8 against its plain version (every output equal) and the sort
    path's segments (equal); with `timed`, K8's time, the plain
    version's, the sort stage's (K1 + the key sort) and its bound."""
    out = cascade.cascade_binning(proj, op, gx, gy, budget)
    ref = cascade.cascade_binning_plain(proj, op, gx, gy, budget, 255.0)
    plain_differ = sum(int((a != b).sum()) for a, b in zip(out, ref))
    sort_differ = segments_differ(out[:3], sort_segments(proj, op, gx, gy,
                                                         budget))
    r = dict(max_abs_err=float(plain_differ + abs(sort_differ)),
             plain_differ=plain_differ, sort_differ=sort_differ,
             total=int(out[3]), overflow=bool(out[4]))
    del ref
    if plain_differ or sort_differ or r["overflow"]:
        fail(f"K8 differs from its plain version or the sort binning: {r}")
    if timed:
        r["ms"] = cuda_ms(lambda: cascade.cascade_binning(
            proj, op, gx, gy, budget), 10)[0]
        r["plain_ms"] = cuda_ms(lambda: cascade.cascade_binning_plain(
            proj, op, gx, gy, budget, 255.0), 1)[0]
        r["sort_stage_ms"] = cuda_ms(lambda: sort_segments(
            proj, op, gx, gy, budget), 10)[0]
        r["library_ms"] = None
        r["bound_ms"], r["bound_by"] = k8_bound(proj, r["total"], gx * gy)
        r["device_split_us"] = device_split(lambda: cascade.cascade_binning(
            proj, op, gx, gy, budget))
        keys = torch.randint(0, 1 << 30, (proj.depth.shape[0],),
                             dtype=torch.int32, device=proj.depth.device)
        r["sort_launches"] = device_split(
            lambda: torch.sort(keys, stable=True))["launches"]
        r["launches_besides_sort"] = (r["device_split_us"]["launches"]
                                      - r["sort_launches"])
        if r["launches_besides_sort"] > cascade.LAUNCHES:
            fail(f"K8 put {r['launches_besides_sort']} operations on the "
                 f"device besides the depth sort's {r['sort_launches']}, "
                 f"more than its design's {cascade.LAUNCHES}")
    return r


def device_split(fn, top: int = 12) -> dict:
    """torch.profiler's device time of one call of `fn`, by kernel (us, the
    `top` largest), with the sum over all its kernels and the call's wall
    time on the host clock. A profile that recorded no device event at all
    (the tracer dropped a call's events: seen on the card for the depth
    sort alone) is taken again; three such profiles fail."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        times, launches = {}, 0
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            if us > 0:
                times[e.key[:80]] = float(us)
                launches += e.count
        if times:
            break
    else:
        fail("torch.profiler recorded no device event in three profiles")
    ranked = sorted(times.items(), key=lambda kv: -kv[1])
    return dict(kernels=dict(ranked[:top]), device_total=sum(times.values()),
                wall=wall, launches=launches)


def cascade_serving(model, clip, consts, plans, f32_loads, dev) -> dict:
    """Phase 16: K8 on a reduced scene, then at both loads of phase 4's
    scene: counted cascade frames (CUDA-event stages, printed beside phase
    4's f32 frame's, `f32_loads`), K8 against its plain version and the
    sort binning, the cascade frame against phase 4's, K8 (with its device
    operations besides the depth sort's, at most cascade.LAUNCHES) and K2
    on its segments timed, and an overflow probe."""
    h = w = 512
    small = from_numpy_params(bench_scene(50_000, seed=1), device=dev)
    view, pm, tfx, tfy = bench_camera(h, w)
    s = RasterizeSettings(h, w, tfx, tfy, 0, max_entries=1 << 20)
    x = stage_inputs(small, s, view, pm, consts, dev)
    reduced = check_k8(x["proj"], x["op"], s.grid_x, s.grid_y, s.max_entries,
                       timed=False)
    log(f"reduced K8: {reduced}")
    del small, x

    zero_counts(CASCADE_WRAPPERS)
    frames = {}
    for name, (s, view, pm) in plans.items():
        sc = s._replace(binning="cascade")
        host, stages = [], []
        for _ in range(FRAMES):
            events = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, relev = frame(model, sc, view, pm, clip, consts, dev, events)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            stages.append({b[0]: a[1].elapsed_time(b[1])
                           for a, b in zip(events, events[1:])})
        frames[name] = (out, relev, host,
                        {k: statistics.median(st[k] for st in stages)
                         for k in stages[0]})
    launches = read_counts(CASCADE_WRAPPERS)
    n = FRAMES * len(plans)
    log(f"launches on the cascade frames ({n}): {launches}")
    if not (launches["K8"] == launches["K2"] == launches["K3"] == n
            and launches["K1"] == 0):
        fail(f"the cascade frames' launches are off: {launches}")

    res = {}
    for name, (s, view, pm) in plans.items():
        out, relev, host, stage_ms = frames.pop(name)
        ref, _ = frame(model, s, view, pm, clip, consts, dev)
        same = [torch.equal(a, b) for a, b in (
            (out.render, ref.render),
            (out.language_feature_weight_map,
             ref.language_feature_weight_map),
            (out.final_transmittance, ref.final_transmittance))]
        kept, live = int(out.total_entries), int(ref.live_total)
        if not (all(same) and kept == live and bool(torch.isfinite(
                relev).all())):
            fail(f"{name}: the cascade frame is not phase 4's frame: "
                 f"{same}, kept {kept}, live {live}")
        del out, ref, relev
        x = stage_inputs(model, s, view, pm, consts, dev)
        r = dict(frame_ms_median=statistics.median(host), frame_ms=host,
                 stage_ms_median=stage_ms,
                 f32_frame_ms_median=f32_loads[name]["frame_ms_median"],
                 f32_stage_ms_median=f32_loads[name]["stage_ms_median"],
                 kept_total=kept,
                 K8=check_k8(x["proj"], x["op"], s.grid_x, s.grid_y,
                             s.max_entries, timed=True))
        g, start, count, _, _ = cascade.cascade_binning(
            x["proj"], x["op"], s.grid_x, s.grid_y, s.max_entries)
        args = (g, start, count, x["geom"], x["bg"], s.grid_x, s.grid_y,
                x["qw"], x["qi"], L * K)
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        blend.blend_tiles(*args, stats=stats)
        check_counts(f"{name} K2 combined", stats, g, start, count,
                     x["geom"], s.grid_x)
        k2 = dict(ms=cuda_ms(lambda: blend.blend_tiles(*args), 10)[0],
                  max_abs_err=max_diff(zip(
                      blend.blend_tiles(*args),
                      blend.blend_tiles(x["g"], x["start"], x["count"],
                                        *args[3:]))),
                  library_ms=None)
        k2["plain_ms"] = cuda_ms(lambda: blend.blend_tiles_plain(
            g, start, count, x["geom"], x["bg"], s.grid_x, x["qw"], x["qi"],
            L * K), 1)[0]
        n_tiles = s.grid_x * s.grid_y
        distinct = int(torch.unique(g[:kept]).numel())
        k2["bound_ms"], k2["bound_by"] = bound(
            kept * 4 + n_tiles * 8 + distinct * (9 * 4 + L * TOPK * 8)
            + n_tiles * 256 * (3 + L * K + 1) * 4,
            int(stats[0]) * BLEND_ALPHA_FLOPS
            + int(stats[1]) * BLEND_INCLUDE_FLOPS)
        r["K2comb"] = k2
        budget = kept // 2
        probe = cascade.cascade_binning(x["proj"], x["op"], s.grid_x,
                                        s.grid_y, budget)
        r["overflow_probe"] = dict(budget=budget, total=int(probe[3]),
                                   overflow=bool(probe[4]))
        if not (r["overflow_probe"]["overflow"]
                and 0 < r["overflow_probe"]["total"] <= budget):
            fail(f"{name}: K8's overflow probe: {r['overflow_probe']}")
        res[name] = r
        log(f"{name} cascade: frame median {r['frame_ms_median']:.3f} ms, "
            f"kept {kept}; overflow probe {r['overflow_probe']}")
        log(f"{name} cascade frame stages (median ms, CUDA events): "
            + ", ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
            + f"; phase 4's f32 frame {r['f32_frame_ms_median']:.3f} ms: "
            + ", ".join(f"{k} {v:.3f}"
                        for k, v in r["f32_stage_ms_median"].items()))
        for k in ("K8", "K2comb"):
            log(f"{name} cascade {k}: " + ", ".join(
                f"{a} {b!r}" for a, b in r[k].items()))
        del x, probe, g, start, count, args
        torch.cuda.empty_cache()
    return dict(reduced=reduced, loads=res, launches=launches)


# ---------------------------- phase 17: the round-4 lm-payload capped chain

def lm_chain_frame(model, s, view, pm, clip, consts, dev, events=None):
    """scripts/profile_capped_stages.py:10-13's chain, from the functions
    under their JAX names: the preprocess, K1 with_alpha (sub-box bounds),
    pack_lm_words, the key sort carrying the word, slice_windows of the
    sorted words, budget_counts_windowed, the [T*cap] windows of ids,
    fast16 K2 on the kept counts, bf16 K3 and the relevancy tail. Stage
    events as `render` names them, with "pack", "slice", "budget" and
    "gather" between."""
    cap, subdiv = CAPPED["cap"], CAPPED["subdiv"]
    gx, gy, n_tiles = s.grid_x, s.grid_y, s.grid_x * s.grid_y
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    with torch.no_grad():
        op = model.get_opacity()[:, 0].contiguous()
        mark_stage(events, "start")
        proj = projection.preprocess(
            model.xyz, model.get_scaling(), model.get_rotation(),
            model.get_features(), None, T(view), T(pm),
            torch.zeros(3, device=dev), s.tanfovx, s.tanfovy, s.image_width,
            s.image_height, 0, opacities=op, cull_alpha=s.cull_alpha)
        mark_stage(events, "preprocess")
        tile, depth, gauss, total, lm = expand.expand_entries(
            proj, op, gx, gy, s.max_entries, with_alpha=subdiv)
        mark_stage(events, "expand")
        words = budget.pack_lm_words(lm)
        mark_stage(events, "pack")
        g_sorted, start, count, w_sorted = expand.sort_entries(
            tile, depth, gauss, n_tiles, payload=words)
        mark_stage(events, "sort")
        win = tuple(budget.slice_windows(w, start, cap) for w in w_sorted)
        mark_stage(events, "slice")
        kept, sat = budget.budget_counts_windowed(
            win, count, cap, subdiv * subdiv, CAPPED["tile_budget"])
        kept = torch.clamp(kept, max=s.tile_cap)
        mark_stage(events, "budget")
        g_win = budget.slice_windows(g_sorted, start, cap).reshape(-1)
        starts = torch.arange(n_tiles, dtype=torch.int32, device=dev) * cap
        rows = blend.pack_fast16_rows(proj.xy, proj.conic, op, proj.rgb,
                                      model.quick_weights,
                                      model.quick_indices)
        mark_stage(events, "gather")
        bg = torch.zeros(3, device=dev)
        _, feat_t, t_t = blend.blend_tiles_fast16(
            g_win, starts, kept, rows, bg, gx, gy, L * TOPK, L * K, True)
        mark_stage(events, "blend")
        relev = clip.relevancy_from_tiles(feat_t, *consts, gx, gy,
                                          s.image_height, s.image_width,
                                          stage_events=events)
    return dict(proj=proj, op=op, total=int(total), lm=lm, words=words,
                start=start, count=count, w_sorted=w_sorted, kept=kept,
                sat=sat, feat=feat_t, final_t=t_t, relev=relev)


def check_k1_alpha(proj, op, s, timed: bool) -> dict:
    """K1 with_alpha on a frame's inputs against its plain version:
    entries equal, lm within 2 f32 ulps, the lm words equal; with `timed`,
    its time beside plain K1's kernel, its plain version's and its bound
    (K1's bytes + 4 s^2 B a slot; ~60 + 45 s^2 f32 operations an entry)."""
    gx, gy, subdiv = s.grid_x, s.grid_y, CAPPED["subdiv"]
    offsets = torch.cumsum(proj.tiles_touched, 0, dtype=torch.int64) \
        - proj.tiles_touched
    k1a = lambda: expand.expand_entries(  # noqa: E731
        proj, op, gx, gy, s.max_entries, with_alpha=subdiv)
    k1a_plain = lambda: expand.expand_entries_plain(  # noqa: E731
        proj, op, offsets, gx, gy, s.max_entries, True,
        float(np.float32(255.0)), subdiv)
    out, ref = k1a(), k1a_plain()
    mismatch = sum(int((a != b).sum()) for a, b in zip(out[:3], ref[:3]))
    lm, lm_ref = out[4], ref[3]
    spacing = torch.abs(torch.nextafter(lm_ref, torch.full_like(
        lm_ref, -math.inf)) - lm_ref)
    live = lm_ref != 0
    ulps = float(((lm - lm_ref).abs()[live] / spacing[live]).max())
    words_differ = sum(int((a != b).sum()) for a, b in zip(
        budget.pack_lm_words(lm), budget.pack_lm_words(lm_ref)))
    r = dict(max_abs_err=float((lm - lm_ref).abs().max()), lm_ulps=ulps,
             entries_differ=mismatch, words_differ=words_differ,
             total=int(out[3]))
    if mismatch or ulps > 2.0 or words_differ:
        fail(f"K1 with_alpha differs from its plain version: {r}")
    del out, ref, lm, lm_ref, spacing, live
    if timed:
        n = op.shape[0]
        n_on = int((proj.tiles_touched > 0).sum())
        r["ms"] = cuda_ms(k1a, 20)[0]
        r["plain_ms"] = cuda_ms(k1a_plain, 3)[0]
        r["k1_ms"] = cuda_ms(lambda: expand.expand_entries(
            proj, op, gx, gy, s.max_entries), 20)[0]
        r["library_ms"] = None
        r["bound_ms"], r["bound_by"] = bound(
            n * 12 + n_on * 44 + s.max_entries * (12 + 4 * subdiv ** 2),
            r["total"] * (CULL_FLOPS + 45 * subdiv ** 2))
    return r


def lm_capped_chain(model, clip, consts, plans, capped_iou, dev) -> dict:
    """Phase 17: the round-4 capped chain on phase 4's scene and budgets,
    budget 1e-6, cap 128, subdiv 2: counted frames at both loads (K1 with
    with_alpha, fast16 K2 and bf16 K3 on every frame), then on each load's
    inputs K1 with_alpha against its plain version and timed, the windowed
    counts against min(budget_counts, cap) on every tile, the kept counts
    beside budget_from_rows' (printed; the bounds differ by design) and
    the relevancy IoU against the exact bf16 frame."""
    wrappers = {"K1": "k1.launches",
                "K1_with_alpha": "k1.alpha_launches",
                "K2f16": blend.blend_tiles_fast16,
                "K3bf16": query.query_map_tiles_bf16}
    zero_counts(wrappers)
    runs = {}
    for name, (s, view, pm) in plans.items():
        host_ms, stages = [], []
        for _ in range(FRAMES):
            events = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = lm_chain_frame(model, s, view, pm, clip, consts, dev,
                                 events)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            stages.append({b[0]: a[1].elapsed_time(b[1])
                           for a, b in zip(events, events[1:])})
        runs[name] = (out, host_ms, stages)
    launches = read_counts(wrappers)
    n_frames = FRAMES * len(plans)
    log(f"launches on the lm-capped chain ({n_frames} frames): {launches}")
    if not all(v == n_frames for v in launches.values()):
        fail(f"a kernel of the lm-capped chain missed a frame: {launches}")

    results = {}
    cap, t_budget = CAPPED["cap"], CAPPED["tile_budget"]
    for name, (s, view, pm) in plans.items():
        out, host_ms, stages = runs.pop(name)
        checks = {
            "total < max_entries": out["total"] < s.max_entries,
            "finite": all(bool(torch.isfinite(t).all()) for t in (
                out["feat"], out["final_t"], out["relev"])),
            "kept <= min(count, cap)": bool((out["kept"] <= torch.clamp(
                out["count"], max=cap)).all()),
        }
        bad = [k for k, v in checks.items() if not v]
        if bad:
            fail(f"{name} lm chain: checks failed: {bad}")
        r = dict(frame_ms_median=statistics.median(host_ms),
                 frame_ms=host_ms,
                 stage_ms_median={k: statistics.median(st[k] for st in stages)
                                  for k in stages[0]},
                 total_entries=out["total"],
                 live_total=int(out["count"].sum()),
                 kept_total=int(out["kept"].sum()))
        n_box = CAPPED["subdiv"] ** 2
        kept_all = budget.budget_counts(
            budget.unpack_lm_words(out["w_sorted"], n_box), out["start"],
            out["count"], t_budget)
        differ = int((torch.clamp(kept_all, max=cap) != out["kept"]).sum())
        r["windowed_vs_budget_counts_differ"] = differ
        if differ:
            fail(f"{name}: budget_counts_windowed differs from "
                 f"min(budget_counts, cap) on {differ} tiles")
        capped_s = bf16_variants(s)["capped"]
        _, _, kept_rows, _, _ = capped_binning(capped_s, out["proj"],
                                               out["op"], True)
        diff = (kept_rows - out["kept"]).abs()
        r["kept_vs_budget_from_rows"] = dict(
            tiles_equal_share=float((diff == 0).float().mean()),
            max_abs_diff=int(diff.max()), kept_rows_total=int(kept_rows.sum()))
        exact, _ = frame(model, bf16_variants(s)["exact"], view, pm, clip,
                         consts, dev)
        masks = [relevancy_mask(*query.query_map_tiles(t, *consts))
                 for t in (exact.language_feature_weight_map, out["feat"])]
        r["relevancy_iou_vs_exact"] = int((masks[0] & masks[1]).sum()) / max(
            int((masks[0] | masks[1]).sum()), 1)
        r["phase10_capped_iou"] = capped_iou[name]
        del exact, masks
        r["K1_with_alpha"] = check_k1_alpha(out["proj"], out["op"], s,
                                            timed=True)
        results[name] = r
        log(f"{name} lm chain: frame median {r['frame_ms_median']:.3f} ms; "
            f"total {r['total_entries']}, live {r['live_total']}, kept "
            f"{r['kept_total']} (budget_from_rows "
            f"{r['kept_vs_budget_from_rows']['kept_rows_total']}); tiles "
            f"with equal kept {r['kept_vs_budget_from_rows']!r}; windowed "
            f"vs budget_counts differ on {differ} tiles; relevancy IoU vs "
            f"exact {r['relevancy_iou_vs_exact']!r} (phase 10 capped "
            f"{r['phase10_capped_iou']!r})")
        log(f"{name} lm chain stages (median ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in r["stage_ms_median"].items()))
        log(f"{name} K1_with_alpha: " + ", ".join(
            f"{a} {b!r}" for a, b in r["K1_with_alpha"].items()))
        del out, kept_all, kept_rows
        torch.cuda.empty_cache()
    return dict(loads=results, launches=launches)


# --------------------------------------------- phase 18: K9, the cell probe

PROBE_BLOCKS = 512                      # profile_vpu_bf16.py's vmapped batch
PROBE_ARITH = 5   # a chain's arithmetic: a = x / 2, a * a, acc +, e * step,
                  # x +  (an FMA would count once)
PROBE_INSTR = 9   # the fewest instructions a chain needs: PROBE_ARITH, the
                  # exp, 2 compares, the select (a pair's, in packed bf16)
SFU_PER_CLOCK_SM = 16   # MUFU results a clock an SM: 4 a partition (planning)
LANES_PER_CLOCK_SM = 128  # FP32 lanes, and 4 warp-instructions issued


# SASS opcodes by the unit that issues them (Hopper: 128 FP32 lanes and 16
# MUFU results a clock an SM; FSETP / FSEL / conversions run elsewhere).
SASS_CLASSES = {"fp32": ("FFMA", "FMUL", "FADD"), "mufu": ("MUFU",),
                "packed_bf16": ("HFMA2", "HMUL2", "HADD2"),
                "compare_select": ("FSETP", "FSEL", "HSETP2", "PLOP3",
                                   "SEL"),
                "convert": ("F2F", "F2FP", "PRMT", "SHF", "IMAD.U32")}


def sass_per_chain(library=None) -> dict:
    """Instructions a chain of K9's kernels, by class, from cuobjdump's
    SASS of the built library (or `library`): the static count over the
    64 unrolled repetitions (a bf16 thread runs two chains), the bf16
    form's out-of-line expf chain included unless `library` is
    `probe_common_path_library()`. Empty when cuobjdump is absent."""
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    dump = subprocess.run([tool, "-sass", str(library or kernels.build()[0])],
                          capture_output=True, text=True, timeout=120)
    if dump.returncode != 0:
        log(f"cuobjdump failed ({dump.returncode}): {dump.stderr[-500:]}")
        return {}
    sass = dump.stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = ("f32" if "chain_f32" in name else "bf16"
                  if "chain_bf16ILi0" in name else "bf16_ex2"
                  if "chain_bf16ILi2" in name else None)
            if fn:
                counts[fn] = dict.fromkeys(("all", *SASS_CLASSES), 0)
            continue
        if fn is None or "/*" not in line or ";" not in line:
            continue
        op = line.split("*/", 1)[1].strip().split()[0]
        if op.startswith("@"):
            op = line.split("*/", 1)[1].strip().split()[1]
        if op != "NOP":
            counts[fn]["all"] += 1
        for cls, prefixes in SASS_CLASSES.items():
            if any(op == p or op.startswith(p + ".") for p in prefixes):
                counts[fn][cls] += 1
    return {fn: {cls: n / (probe.REPS * (1 if fn == "f32" else 2))
                 for cls, n in c.items()} for fn, c in counts.items()}


def probe_common_path_library() -> Path:
    """csrc/probe.cu built alone with -DLSV2_PROBE_HOT_PATH (the bf16
    chain's fallback left out, its check kept), for counting the common
    path's SASS; fails the run if nvcc does."""
    out = Path("build") / "chip_smoke_probe"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libprobe_common.so"
    done = subprocess.run(
        [kernels._nvcc(), *kernels.ARCH, *kernels.COMMON,
         *kernels.SOURCES["probe.cu"], "-DLSV2_PROBE_HOT_PATH", "-shared",
         "-o", str(lib), str(kernels.CSRC / "probe.cu")],
        capture_output=True, text=True, timeout=300)
    if done.returncode:
        fail(f"nvcc probe.cu -DLSV2_PROBE_HOT_PATH: {done.stdout[-2000:]}"
             f"{done.stderr[-2000:]}")
    return lib


def probe_floors(chains: int, elements: int, dev) -> dict:
    """K9's five floors (ms) and each form's bound: bytes (8 B an element),
    the MUFU (one exp a chain at SFU_PER_CLOCK_SM results a clock an SM),
    the FP32 lanes (f32: PROBE_ARITH a chain at 128 lanes a clock an SM),
    the packed lanes (bf16: the same arithmetic, two a lane) and the issue
    slots (PROBE_INSTR a chain in f32, a pair in bf16, at 4
    warp-instructions a clock an SM), at the card's highest SM clock."""
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lanes = n_sm * LANES_PER_CLOCK_SM * clock_mhz * 1e6
    sfu = n_sm * SFU_PER_CLOCK_SM * clock_mhz * 1e6
    floors = dict(bytes=elements * 8 / HBM_BYTES_PER_S * 1e3,
                  mufu=chains / sfu * 1e3,
                  fp32_lanes=chains * PROBE_ARITH / lanes * 1e3,
                  packed_lanes=chains * PROBE_ARITH / 2 / lanes * 1e3,
                  issue_f32=chains * PROBE_INSTR / lanes * 1e3,
                  issue_bf16=chains * PROBE_INSTR / 2 / lanes * 1e3)
    forms = {"f32": ("bytes", "mufu", "fp32_lanes", "issue_f32"),
             "bf16": ("bytes", "mufu", "packed_lanes", "issue_bf16")}
    res = dict(floors=floors, clock_mhz=clock_mhz, sms=n_sm,
               old_bound_ms=max(floors["bytes"], floors["mufu"],
                                chains * 8 / F32_FLOPS * 1e3))
    for form, keys in forms.items():
        top = max(keys, key=lambda k: floors[k])
        res[form] = dict(
            bound_ms=floors[top],
            bound_by="bytes" if top == "bytes" else "operations",
            bound_basis="largest of " + ", ".join(
                f"{k} {floors[k]:.4f}" for k in keys) + f" ms: {top}")
    return res


def cell_probe(dev) -> dict:
    """Phase 18: K9 in f32 and bf16 on [512, 256, 256], counted, each
    against its plain version (f32 1e-5 of the largest, bf16 2 bf16 ulps
    of the largest, and the elements that differ at all), timed beside its
    plain version and its bound (`probe_floors`, the earlier one-floor
    bound beside it); the rates in G chains/s, the bf16/f32 ratio, the
    pairs whose bf16 chain ran again with expf, SASS a chain (static and on
    the bf16 form's common path), and the ex2.approx.bf16x2 what-if (not
    K9's arithmetic) timed beside it."""
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((PROBE_BLOCKS, 256, 256), generator=gen, device=dev) \
        * 2 - 1
    chains = x.numel() * probe.REPS
    fl = probe_floors(chains, x.numel(), dev)
    clock_mhz, n_sm = fl["clock_mhz"], fl["sms"]
    sfu_rate = n_sm * SFU_PER_CLOCK_SM * clock_mhz * 1e6
    basis = "; ".join(f"{d}: {fl[d]['bound_basis']}" for d in ("f32", "bf16"))
    zero_counts({"K9": probe.cell_chain})
    outs = {d: probe.cell_chain(x, dt) for d, dt in
            (("f32", torch.float32), ("bf16", torch.bfloat16))}
    launches = read_counts({"K9": probe.cell_chain})["K9"]
    if launches != 2:
        fail(f"K9 launched {launches} times, not 2")
    res = dict(blocks=PROBE_BLOCKS, chains=chains, bound_basis=basis,
               launches=launches, floors_ms=fl["floors"],
               old_bound_ms=fl["old_bound_ms"])
    for d, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ref = probe.cell_chain_plain(x, dt)
        big = float(ref.abs().max())
        err = float((outs[d] - ref).abs().max())
        lim = (1e-5 * big if d == "f32"
               else 2 * 2.0 ** (math.floor(math.log2(big)) - 7))
        r = dict(max_abs_err=err, limit=lim, largest=big,
                 elements_differ=int((outs[d] != ref).sum()))
        if not err <= lim or r["elements_differ"]:
            fail(f"K9 {d} differs from its plain version: {r}")
        del ref
        r["ms"] = cuda_ms(lambda: probe.cell_chain(x, dt), 10)[0]
        r["plain_ms"] = cuda_ms(lambda: probe.cell_chain_plain(x, dt), 1)[0]
        r["library_ms"] = None
        r["bound_ms"], r["bound_by"] = fl[d]["bound_ms"], fl[d]["bound_by"]
        r["bound_basis"] = fl[d]["bound_basis"]
        r["gchains_per_s"] = chains / (r["ms"] * 1e-3) / 1e9
        res[d] = r
    res["bf16_ex2_what_if_ms"], out = cuda_ms(
        lambda: probe.kernel_mode(x, probe.WHAT_IF)[0], 10)
    res["bf16_ex2_what_if_err"] = float((out - outs["bf16"]).abs().max())
    res["bf16_over_f32_rate"] = res["f32"]["ms"] / res["bf16"]["ms"]
    res["bf16_pairs_fell_back"] = probe.kernel_mode(x, 1)[1]
    res["sass_per_chain_static"] = sass_per_chain()
    res["sass_per_chain"] = sass_per_chain(probe_common_path_library())
    # What each rate alone would take: every instruction at one warp
    # instruction a clock a scheduler (4 an SM, 128 lanes), the FP32-pipe
    # ones at 128 lanes a clock an SM, MUFU at SFU_PER_CLOCK_SM.
    lane_rate = n_sm * 128 * clock_mhz * 1e6
    res["pipe_ms"] = {fn: dict(
        issue=chains * c["all"] / lane_rate * 1e3,
        fp32_pipe=chains * (c["fp32"] + c["packed_bf16"]) / lane_rate * 1e3,
        mufu=chains * c["mufu"] / sfu_rate * 1e3)
        for fn, c in res["sass_per_chain"].items()}
    log(f"K9 SASS a chain (common path): {res['sass_per_chain']}; static "
        f"(the out-of-line expf chain included): "
        f"{res['sass_per_chain_static']}; issue-rate times {res['pipe_ms']}")
    log(f"K9 cell probe on {x.shape}: f32 {res['f32']['ms']:.4f} ms = "
        f"{res['f32']['gchains_per_s']:.1f} G chains/s, bf16 "
        f"{res['bf16']['ms']:.4f} ms = {res['bf16']['gchains_per_s']:.1f} "
        f"G chains/s, bf16_over_f32_rate {res['bf16_over_f32_rate']:.3f}; "
        f"bounds {basis} (the earlier bound {res['old_bound_ms']:.4f}: "
        f"bytes, the MUFU and 8 ops a chain at 67 TFLOP/s); "
        f"{res['bf16_pairs_fell_back']} of {x.numel() // 2} bf16 pairs ran "
        f"the chain again with expf; bf16 with ex2.approx.bf16x2 (what-if) "
        f"{res['bf16_ex2_what_if_ms']:.4f} ms, {res['bf16_ex2_what_if_err']}"
        f" from K9 bf16")
    for d in ("f32", "bf16"):
        log(f"K9 {d}: " + ", ".join(f"{a} {b!r}" for a, b in res[d].items()))
    del x, out, outs
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------- phase 19: the eval drivers

EVAL_H, EVAL_W = 728, 986               # the LERF eval resolution
EVAL_SIZES = (1_000_000, 750_000, 500_000)
EVAL_YAWS = (-4.0, -1.5, 1.5, 4.0)      # 4 annotated frames
EVAL_PROMPTS = ("teddy bear", "coffee mug", "book", "plant")
EVAL_WRAPPERS = {"K1": "k1.launches", "K2": blend.blend_tiles,
                 "K3": query.query_map_tiles}


def eval_gt(seed: int, n_frames: int, h: int, w: int) -> dict:
    """Rectangular GT masks and their boxes (x1 y1 x2 y2), from a seed."""
    rng = np.random.default_rng(seed)
    gt_ann = {}
    for j in range(n_frames):
        ann = {}
        for p in EVAL_PROMPTS:
            bh, bw = rng.integers(h // 8, h // 3), rng.integers(w // 8, w // 3)
            y0, x0 = rng.integers(0, h - bh), rng.integers(0, w - bw)
            m = np.zeros((h, w), bool)
            m[y0:y0 + bh, x0:x0 + bw] = True
            ann[p] = {"mask": m, "bboxes": np.array([x0, y0, x0 + bw,
                                                     y0 + bh])}
        gt_ann[str(j)] = ann
    return gt_ann


def level_models(n: int, h: int, w: int, seed: int, dev):
    """Three per-level models (one layer of K codes each) on the bench
    scene's geometry, logits and codebooks from a seed, and their merge."""
    base = bench_scene(n, seed)
    rng = np.random.default_rng(seed + 50)
    models = []
    for _ in range(L):
        f = {k: v for k, v in base.items()
             if k not in ("quick_weights", "quick_indices", "codebooks")}
        f["language_logits"] = rng.normal(size=(n, K)).astype(np.float32)
        f["codebooks"] = rng.normal(size=(1, K, DIM)).astype(np.float32)
        models.append(from_numpy_params(f, device=dev))
    return models, lerf.merge_level_models(models)


def eval_path(dev) -> dict:
    """Phase 19: the golden fixture on the card; evaluate_quick at full
    width (the bench scene at the largest of EVAL_SIZES whose 4 frames all
    stay inside make_settings' 2**21 entries), counted and timed a frame
    by stage; evaluate against evaluate_quick on a reduced scene; LPIPS and
    PSNR on one frame."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from torch_port_fixtures import check_golden_eval, golden_eval

    res = {"golden": check_golden_eval(golden_eval(dev))}
    log(f"golden eval fixture on the card: largest differences "
        f"{res['golden']} (atol 1e-5)")

    cams = train_cameras("eval", EVAL_YAWS, EVAL_H, EVAL_W)
    gt_ann = eval_gt(7, len(cams), EVAL_H, EVAL_W)
    tried = {}
    for n in EVAL_SIZES:
        model = from_numpy_params(bench_scene(n), device=dev)
        totals = []
        with torch.no_grad():
            for cam in cams:
                out = render(make_settings(cam, 0)._replace(assemble=False),
                             model, cam.world_view_transform,
                             cam.full_proj_transform, cam.camera_center,
                             np.zeros(3, np.float32), quick_render=True,
                             device=dev)
                totals.append(int(out.total_entries))
        tried[n] = totals
        if max(totals) < 2 ** 21:
            break
        del model
    else:
        fail(f"every eval frame overflows 2**21 entries at every size: "
             f"{tried}")
    log(f"eval scene: {n} Gaussians; total entries a frame {totals} "
        f"(2**21 = {2 ** 21}); tried {tried}")
    clip = OpenCLIPNetwork("hash", device=dev)
    lerf.evaluate_quick(model, cams[:1], {"0": gt_ann["0"]}, (EVAL_H, EVAL_W),
                        clip, device=dev)                       # warm-up
    zero_counts(EVAL_WRAPPERS)
    events = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = lerf.evaluate_quick(model, cams, gt_ann, (EVAL_H, EVAL_W),
                                  clip, device=dev, stage_events=events)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts(EVAL_WRAPPERS)
    if not all(v == len(cams) for v in launches.values()):
        fail(f"a kernel of evaluate_quick missed a frame: {launches}")
    split = {"render + relevancy": [], "segmentation": [], "localization": []}
    marks = {}
    for (name, ev) in events:
        if name == "start":
            marks = {"start": ev}
        marks[name] = ev
        if name == "localization":
            split["render + relevancy"].append(
                marks["start"].elapsed_time(marks["relevancy"]))
            split["segmentation"].append(
                marks["relevancy"].elapsed_time(marks["segmentation"]))
            split["localization"].append(
                marks["segmentation"].elapsed_time(marks["localization"]))
    n_prompts = len(cams) * len(EVAL_PROMPTS)
    if not (metrics["num_prompts"] == n_prompts
            and 0.0 <= metrics["mean_iou"] <= 1.0
            and len(split["localization"]) == len(cams)):
        fail(f"evaluate_quick: {metrics}, {len(split['localization'])} "
             "frames timed")
    res["evaluate_quick"] = dict(
        gaussians=n, totals=totals, tried=tried, metrics=metrics,
        wall_ms=wall_ms, frame_ms=wall_ms / len(cams), launches=launches,
        stage_ms_median={k: statistics.median(v) for k, v in split.items()})
    log(f"evaluate_quick, {len(cams)} frames at {EVAL_W}x{EVAL_H}, "
        f"{n} Gaussians: mean_iou {metrics['mean_iou']!r}, localization "
        f"accuracy {metrics['localization_accuracy']!r}, {wall_ms:.1f} ms "
        f"({wall_ms / len(cams):.1f} a frame); device medians a frame "
        + ", ".join(f"{k} {v:.3f} ms"
                    for k, v in res["evaluate_quick"]["stage_ms_median"]
                    .items()) + f"; launches {launches}")

    rgb = render(make_settings(cams[0], 0), model,
                 cams[0].world_view_transform, cams[0].full_proj_transform,
                 cams[0].camera_center, np.zeros(3, np.float32),
                 device=dev).render
    del model
    torch.cuda.empty_cache()
    img = torch.rand(rgb.shape, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    params = lpips_mod.random_params("vgg", seed=0)
    net = lpips_mod.LPIPS(params, "vgg").to(dev)
    with torch.no_grad():
        ms, dist = cuda_ms(lambda: net(rgb[None], img[None]), 3)
    cam_gt = Camera(0, cams[0].R, cams[0].T, cams[0].FoVx, cams[0].FoVy,
                    rgb.clamp(0, 1).cpu().numpy() * 0.9, "psnr", 0)
    model = from_numpy_params(bench_scene(n), device=dev)
    t0 = time.perf_counter()
    mean_psnr, _ = psnr_eval.evaluate_psnr(model, [cam_gt], device=dev)
    psnr_ms = (time.perf_counter() - t0) * 1e3
    if not (math.isfinite(float(dist[0])) and float(dist[0]) > 0
            and math.isfinite(mean_psnr)):
        fail(f"LPIPS {dist} or PSNR {mean_psnr} is not finite")
    res["lpips_psnr"] = dict(lpips_vgg=float(dist[0]), lpips_ms=ms,
                             psnr=mean_psnr, psnr_ms=psnr_ms)
    log(f"LPIPS (VGG, random weights) on a {EVAL_W}x{EVAL_H} frame: "
        f"{float(dist[0])!r}, {ms:.3f} ms; evaluate_psnr of one frame "
        f"{mean_psnr:.3f} dB, {psnr_ms:.1f} ms (host clock)")
    del model, net
    torch.cuda.empty_cache()

    models, merged = level_models(50_000, 512, 512, 1, dev)
    rcams = train_cameras("reduced", (-2.0, 2.0), 512, 512)
    rgt = eval_gt(11, len(rcams), 512, 512)
    clip.set_positives(list(EVAL_PROMPTS))
    full = lerf.evaluate(models, rcams, rgt, (512, 512), clip, device=dev)
    quick = lerf.evaluate_quick(merged, rcams, rgt, (512, 512), clip,
                                gram_relevancy=False, device=dev)
    gram = lerf.evaluate_quick(merged, rcams, rgt, (512, 512), clip,
                               device=dev)
    d_iou = abs(full["mean_iou"] - quick["mean_iou"])
    res["evaluate_vs_quick"] = dict(full=full, quick=quick, gram=gram,
                                    mean_iou_diff=d_iou)
    log(f"evaluate (3 level models) vs evaluate_quick (their merge) on "
        f"50k Gaussians at 512x512: mean IoU {full['mean_iou']!r} / "
        f"{quick['mean_iou']!r} (diff {d_iou}, limit 1e-4), levels "
        f"{full['chosen_levels']} / {quick['chosen_levels']}, localization "
        f"{full['localization_accuracy']} / "
        f"{quick['localization_accuracy']}; the Gram route "
        f"{gram['mean_iou']!r}, levels {gram['chosen_levels']}")
    if not (d_iou <= 1e-4 and full["chosen_levels"] == quick["chosen_levels"]
            and full["localization_accuracy"]
            == quick["localization_accuracy"]):
        fail("evaluate and evaluate_quick disagree on the reduced scene")
    del models, merged
    torch.cuda.empty_cache()
    return res


# ---------------------- phase 20: the shapes past the main path's designs

def many_prompts_serving(model, plans, dev) -> dict:
    """Phase 20 (serving): 1080p frames with MANY_POSITIVES (13 positives, as
    eval/lerf.py::quick_relevancy sends a frame's: PQ = 17 a level, past
    K3's and K2q's main-path design), one f32 frame (render +
    relevancy_from_tiles: K3), one bf16 frame (K3 bf16) and one fused frame
    (rasterize_quick_query: K2q), the launch counts zeroed before and read
    after; then each kernel on its frame's own inputs against its plain
    version (K3 rtol/atol 1e-5; K2q rgb and T atol 3e-5, raw and nrm2 1e-5
    of their largest, and against the unfused routes) and timed."""
    clip = OpenCLIPNetwork("hash", device=dev)
    clip.set_positives(MANY_POSITIVES)
    consts = clip.prompt_constants(model.codebooks)
    s, view, pm = plans["1080p"]
    sb = bf16_variants(s)["exact"]
    zero_counts(MANY_PQ_WRAPPERS)
    with torch.no_grad():
        f32, rel32 = frame(model, s, view, pm, clip, consts, dev)
        f16, rel16 = frame(model, sb, view, pm, clip, consts, dev)
        fused, relq = query_frame(model, sb, view, pm, clip, consts, dev)
    launches = read_counts(MANY_PQ_WRAPPERS)
    log(f"phase 20: launches over an f32, a bf16 and a fused 1080p frame "
        f"at PQ = {MANY_PQ}: {launches}")
    if launches != {k: 1 for k in MANY_PQ_WRAPPERS}:
        fail(f"phase 20: a kernel of the 13-positive frames did not launch "
             f"once: {launches}")
    shape = (L, len(MANY_POSITIVES), s.image_height, s.image_width)
    for name, rel in (("f32", rel32), ("bf16", rel16), ("fused", relq)):
        if not (tuple(rel.shape) == shape and bool(torch.isfinite(rel).all())
                and bool(((rel >= 0) & (rel <= 1)).all())):
            fail(f"phase 20 {name} frame: relevancy {tuple(rel.shape)} (want "
                 f"{shape}), not finite or outside [0, 1]")
    del rel32, rel16, relq, fused
    r = dict(launches=launches)
    r["K3"] = check_query_f32(f32.language_feature_weight_map, *consts,
                              "phase 20 K3")
    del f32
    r["K3bf16"] = check_query_bf16(f16.language_feature_weight_map, *consts,
                                   timed=True)
    del f16
    x = fast16_inputs(model, sb, view, pm, dev)
    r["K2q"] = check_query_kernel(x, sb, consts, timed=True)
    del x
    for k in ("K3", "K3bf16", "K2q"):
        log(f"phase 20 1080p PQ={MANY_PQ} {k}: " + ", ".join(
            f"{a} {b!r}" for a, b in r[k].items()))
    torch.cuda.empty_cache()
    return r


def small_k_training(dev) -> dict:
    """Phase 20 (training): SMALL_K_ITERS train_features steps at codebook_size
    SMALL_K on phase 7's scene and cameras (K6a and K6b at M = K = 32, the
    launch counts zeroed before and read after), then K6a, K6b and K4 on
    one step's own inputs (check_train_kernels: phase 7's limits), timed;
    and K6a and K6b at M = 256 (the last layer of vq_layer_num 4) on
    gram_wide_inputs against their plain versions, timed."""
    model, _ = train_scene(TRAIN_N, 0, dev, SMALL_K)
    cams = train_cameras("cam", TRAIN_YAW_DEG, TRAIN_H, TRAIN_W)
    opt = type("Opt", (), {"language_feature_lr": 0.0025})()
    metrics_log = []
    zero_counts(SMALL_K_WRAPPERS)
    model, _optimizer, logs = trainer.train_features(
        model, cams, opt, GT_DIR, 1, iterations=SMALL_K_ITERS, seed=0,
        max_entries=2 ** 21, feature_cache={}, device=dev,
        on_iteration=lambda _i, _m, _o, m: metrics_log.append(
            {k: float(v) for k, v in m.items()}))
    launches = read_counts(SMALL_K_WRAPPERS)
    log(f"phase 20 training at codebook_size {SMALL_K}: {SMALL_K_ITERS} "
        f"steps, losses {logs.losses}, launches {launches}")
    if launches != {k: SMALL_K_ITERS for k in SMALL_K_WRAPPERS}:
        fail(f"phase 20: the K={SMALL_K} steps did not launch K6a and K6b "
             f"once a step: {launches}")
    if not all(math.isfinite(v) for v in logs.losses):
        fail(f"phase 20: non-finite loss at codebook_size {SMALL_K}: "
             f"{logs.losses}")
    budget = list(logs.live_budget.values())
    x = train_step_inputs(model, cams[0], 2 ** 21, budget[0], dev)
    r = dict(launches=launches, losses=logs.losses,
             step=check_train_kernels(x, dev, timed=True))
    del x, model
    r["M=256"] = check_gram_wide(dev, layers=4)
    for k, v in r["step"].items():
        log(f"phase 20 K={SMALL_K} step {k}: " + ", ".join(
            f"{a} {b!r}" for a, b in v.items()))
    log(f"phase 20 M=256: {r['M=256']}")
    torch.cuda.empty_cache()
    return r


def wide_expand_case(dev, n: int = 100_000, whole: int = 16, seed: int = 7):
    """K1's edge shapes at the scale of a 1080p frame (phase 20,
    profile_expand.py): a 120 x 68 tile grid and n Gaussians, `whole` of
    them (spread over the list) with rects over all 8,160 tiles whose far
    tiles the cull kills, runs of 8 that touch no tile (~30%), the rest
    rects of 1-20 tiles; centres, conics, depths and opacities from a
    seed. Returns (proj, opacities, grid_x, grid_y, cuts): max_entries past
    the total, in the middle of the first and of the middle whole-grid
    rect, and one slot past a block edge (csrc/expand.cu's 2,048 slots)
    inside the latter."""
    rng = np.random.default_rng(seed)
    gx, gy = 120, 68
    w = rng.integers(1, 6, n)
    h = rng.integers(1, 5, n)
    x0 = rng.integers(0, gx - w + 1)
    y0 = rng.integers(0, gy - h + 1)
    w[np.repeat(rng.uniform(size=-(-n // 8)) < 0.3, 8)[:n]] = 0
    big = np.linspace(n // (2 * whole), n - 1, whole).astype(np.int64)
    x0[big], y0[big], w[big], h[big] = 0, 0, gx, gy
    lo = np.stack([x0, y0], 1) * 16.0
    hi = np.stack([x0 + np.maximum(w, 1), y0 + h], 1) * 16.0
    xy = rng.uniform(lo, hi)
    sig = rng.uniform(3.0, 15.0, (n, 2))
    rho = rng.uniform(-0.6, 0.6, n)
    xy[big], sig[big], rho[big] = (8.0 * gx, 8.0 * gy), 16.0 * gx / 6, 0.0
    det = (sig[:, 0] * sig[:, 1]) ** 2 * (1 - rho ** 2)
    conic = np.stack([sig[:, 1] ** 2 / det,
                      -rho * sig[:, 0] * sig[:, 1] / det,
                      sig[:, 0] ** 2 / det], 1)
    tiles = (w * h).astype(np.int32)
    T = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a), dtype=dt, device=dev)
    proj = projection.ProjectedGaussians(
        xy=T(xy), depth=T(rng.uniform(2.0, 12.0, n)), conic=T(conic),
        radius=T(np.where(tiles > 0, 8, 0), torch.int32), rgb=None,
        rect_min=T(np.stack([x0, y0], 1), torch.int32),
        rect_max=T(np.stack([x0 + w, y0 + h], 1), torch.int32),
        tiles_touched=T(tiles, torch.int32))
    ends = np.cumsum(tiles, dtype=np.int64)
    mid = [int(ends[big[k]] - tiles[big[k]] // 2) for k in (0, whole // 2)]
    cuts = [int(ends[-1]) + 1000, *mid, (mid[1] // 2048 + 1) * 2048 + 1]
    return proj, T(rng.uniform(0.2, 0.95, n)), gx, gy, cuts


def k1_edge_shapes(dev) -> dict:
    """Phase 20 (binning): K1 on wide_expand_case at each cut, without and
    with with_alpha, against its plain version (entries and total equal,
    lm within 2 f32 ulps and 0 where the plain version's is, the lm words
    equal); timed at the first cut (a tail past the total)."""
    proj, op, gx, gy, cuts = wide_expand_case(dev)
    offsets = torch.cumsum(proj.tiles_touched, 0, dtype=torch.int64) \
        - proj.tiles_touched
    n_tiles = int(proj.tiles_touched.sum())
    r = dict(gaussians=op.shape[0], slots=n_tiles, cuts=cuts, checks=[])
    for sub in (0, CAPPED["subdiv"]):
        for cut in cuts:
            out = expand.expand_entries(proj, op, gx, gy, cut,
                                        with_alpha=sub)
            ref = expand.expand_entries_plain(proj, op, offsets, gx, gy, cut,
                                              True, float(np.float32(255.0)),
                                              sub)
            c = dict(with_alpha=sub, max_entries=cut, total=int(out[3]),
                     entries_differ=sum(int((a != b).sum()) for a, b in
                                        zip(out[:3], ref[:3])))
            if sub:
                lm, lm_ref = out[4], ref[3]
                spacing = torch.abs(torch.nextafter(lm_ref, torch.full_like(
                    lm_ref, -math.inf)) - lm_ref)
                live = lm_ref != 0
                c["lm_zeros_differ"] = int(((lm == 0) != ~live).sum())
                c["lm_ulps"] = float(((lm - lm_ref).abs()[live]
                                      / spacing[live]).max())
                c["words_differ"] = sum(
                    int((a != b).sum()) for a, b in zip(
                        budget.pack_lm_words(lm),
                        budget.pack_lm_words(lm_ref)))
            r["checks"].append(c)
            del out, ref
            if (c["total"] != min(n_tiles, cut) or c["entries_differ"]
                    or c.get("lm_zeros_differ") or c.get("lm_ulps", 0) > 2.0
                    or c.get("words_differ")):
                fail(f"phase 20: K1 on the whole-grid shapes differs from "
                     f"its plain version: {c}")
        r[f"ms_with_alpha_{sub}"] = cuda_ms(lambda: expand.expand_entries(
            proj, op, gx, gy, cuts[0], with_alpha=sub), 20)[0]
    log(f"phase 20 K1 on {n_tiles} slots of whole-grid shapes "
        f"({r['gaussians']} Gaussians, 120 x 68 tiles), cuts {cuts}: equal "
        f"to the plain version in both modes; " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items() if k.startswith("ms_")))
    torch.cuda.empty_cache()
    return r


def write_scene_dir(root: Path, h: int = TRAIN_H, w: int = TRAIN_W) -> None:
    """Phase 21's scene directory: COLMAP sparse/0 (binary) with
    scripts/profile_train.py's 300,000 points and colours (its draws in its
    order), 8 PINHOLE cameras on a yaw arc (60 degrees vertical field of
    view, centres off the origin), one seeded U(0, 1) PNG a camera at its
    native size, and language_features/<image>_{s,f}.npy as write_gt
    builds them."""
    from PIL import Image

    from langsplatv2_tpu_torch.scene import colmap

    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-4, 4, (TRAIN_N, 2)),
                          rng.uniform(2.0, 12.0, (TRAIN_N, 1))], 1)
    cols = rng.uniform(0, 1, (TRAIN_N, 3))
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    focal = h / (2 * math.tan(math.radians(60) / 2))
    colmap.write_intrinsics_binary(str(sparse / "cameras.bin"), {
        1: colmap.ColmapCamera(1, "PINHOLE", w, h,
                               np.array([focal, focal, w / 2, h / 2]))})
    # images.bin holds world-to-camera rotations: a camera turned by t about
    # y has the quaternion of a turn by -t.
    colmap.write_extrinsics_binary(str(sparse / "images.bin"), {
        i + 1: colmap.ColmapImage(
            i + 1, np.array([math.cos(math.radians(-deg) / 2), 0.0,
                             math.sin(math.radians(-deg) / 2), 0.0]),
            np.array([0.05, -0.03, 0.1]), 1, f"cam{i}.png")
        for i, deg in enumerate(SCENE_YAW_DEG)})
    colmap.write_points3d_binary(str(sparse / "points3D.bin"), pts, cols)
    (root / "images").mkdir()
    for i in range(len(SCENE_YAW_DEG)):
        Image.fromarray((rng.uniform(size=(h, w, 3)) * 255).astype(
            np.uint8)).save(root / "images" / f"cam{i}.png")
    write_gt(rng, "cam", len(SCENE_YAW_DEG), h, w,
             out_dir=str(root / "language_features"))


def scene_dir_path(dev, smi: str) -> dict:
    """Phase 21: train both phases from a scene directory through
    `python -m langsplatv2_tpu_torch.train.cli`'s main, in process on the
    card: the geometry phase (24 iterations, accum_iter 2), then feature
    phases from its checkpoint (k-means codebooks, --cos_loss --topk 4):
    (a) 24 iterations, (b) 24 at cam_batch 4, (c) 16 at cam_batch 4 on
    the capped route, (d) 8 in pixel space (l1, normalize, accum_iter 2),
    and (b) resumed for 4 more; each run's launch counts, losses and step
    times. Then the trained model as a reference .pth: read back, its
    quick frame (render(include_feature=True)) bit-equal to the .npz
    model's."""
    import io as pyio
    import shutil

    from langsplatv2_tpu_torch.models import io as mio
    from langsplatv2_tpu_torch.models.torch_interop import \
        save_torch_checkpoint
    from langsplatv2_tpu_torch.train import cli

    root = Path("build") / "chip_smoke_scene"
    shutil.rmtree(root, ignore_errors=True)
    scene, out = root / "scene", root / "out"
    t0 = time.perf_counter()
    write_scene_dir(scene)
    write_s = time.perf_counter() - t0
    base = ["-s", str(scene), "--max_entries", str(SCENE_MAX_ENTRIES)]
    feature = ["--include_feature", "--start_checkpoint",
               str(out / "g_-1" / "chkpnt24.npz"), "--feature_level", "1",
               "--cos_loss", "--topk", "4"]
    runs = [
        ("geometry", ["-m", str(out / "g"), "--iterations", "24",
                      "--accum_iter", "2"], 1,
         ("K1", "K2", "K7"), ("K4", "K5", "K6a", "K6b")),
        ("a", ["-m", str(out / "a"), *feature, "--iterations", "24"], 1,
         ("K1", "K2", "K4", "K6a", "K6b"), ("K5", "K7")),
        ("b", ["-m", str(out / "b"), *feature, "--iterations", "24",
               "--cam_batch", "4"], 4,
         ("K1", "K2", "K4", "K6a", "K6b"), ("K5", "K7")),
        ("c", ["-m", str(out / "c"), *feature, "--iterations", "16",
               "--cam_batch", "4", "--tile_budget", "1e-6"], 4,
         ("K1", "K2", "K5", "K6a", "K6b"), ("K4", "K7")),
        ("d", ["-m", str(out / "d"), *feature, "--iterations", "8",
               "--l1_loss", "--normalize", "--accum_iter", "2"], 1,
         ("K1", "K2", "K4"), ("K5", "K6a", "K6b", "K7")),
        ("b resumed", ["-m", str(out / "b"), "--include_feature",
                       "--start_checkpoint",
                       str(out / "b_1" / "chkpnt24.npz"), "--feature_level",
                       "1", "--cos_loss", "--topk", "4", "--iterations",
                       "28", "--cam_batch", "4"], 4,
         ("K1", "K2", "K4", "K6a", "K6b"), ("K5", "K7")),
    ]
    res = {"scene_write_s": write_s, "runs": {}}
    for name, argv, group, launched, idle in runs:
        zero_counts(SCENE_WRAPPERS)
        captured = pyio.StringIO()
        stdout, sys.stdout = sys.stdout, captured
        t0 = time.perf_counter()
        try:
            summary = cli.main(base + argv)
        finally:
            sys.stdout = stdout
        wall = time.perf_counter() - t0
        launches = read_counts(SCENE_WRAPPERS)
        it_ms = summary["iteration_ms"]
        steps = [sum(it_ms[i:i + group]) for i in range(0, len(it_ms), group)]
        r = dict(first_iter=summary["first_iter"],
                 last_iter=summary["last_iter"], wall_s=wall,
                 scene_s=summary["scene_s"], kmeans_s=summary["kmeans_s"],
                 losses=summary["losses"], step_ms=steps,
                 step_ms_median=statistics.median(steps),
                 ms_per_camera=statistics.median(steps) / group,
                 launches=launches, live_budget=summary["live_budget"],
                 exp_budget=summary["exp_budget"],
                 total_entries_max=max(summary["total_entries"]),
                 output=captured.getvalue().splitlines())
        res["runs"][name] = r
        losses = r["losses"]
        log(f"phase 21 {name}: iterations {r['first_iter'] + 1}.."
            f"{r['last_iter']}, median step {r['step_ms_median']:.3f} ms "
            f"({group} camera(s) a step, {r['ms_per_camera']:.3f} ms a "
            f"camera), loss first {losses[0]!r} last {losses[-1]!r}, scene "
            f"load {r['scene_s']:.3f} s, k-means "
            + ("-" if r["kmeans_s"] is None else f"{r['kmeans_s']:.3f} s")
            + f", {wall:.1f} s in all; launches {launches} ({smi})")
        if not all(math.isfinite(v) for v in losses):
            fail(f"phase 21 {name}: non-finite loss {losses}")
        if any(launches[k] == 0 for k in launched) or any(
                launches[k] for k in idle):
            fail(f"phase 21 {name}: launches {launches}, expected "
                 f"{launched} and none of {idle}")
        if max(summary["total_entries"]) >= SCENE_MAX_ENTRIES:
            fail(f"phase 21 {name}: the expansion reached max_entries")
        if len(losses) >= 16 and not (statistics.mean(losses[-8:])
                                      < statistics.mean(losses[:8])):
            # Eight cameras: the first and the last eight iterations each
            # see every camera once.
            fail(f"phase 21 {name}: the loss did not fall: {losses}")
    resumed = res["runs"]["b resumed"]
    if resumed["first_iter"] != 24 or any(
            "resuming with fresh moments" in line
            for line in resumed["output"]):
        fail("phase 21: the resume did not restore its Adam moments")
    if res["runs"]["a"]["kmeans_s"] is None:
        fail("phase 21: no k-means codebooks")
    res["launches"] = {k: sum(r["launches"][k] for r in res["runs"].values())
                       for k in SCENE_WRAPPERS}

    npz = out / "b_1" / "chkpnt28.npz"
    pth = root / "chkpnt28.pth"

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        v = fn()
        torch.cuda.synchronize()
        return v, time.perf_counter() - t

    (model_n, it_n), load_npz_s = timed(
        lambda: mio.load_checkpoint_auto(str(npz), device=dev))
    _, save_npz_s = timed(lambda: mio.save_checkpoint(
        str(root / "resaved.npz"), model_n, None, it_n))
    _, save_pth_s = timed(lambda: save_torch_checkpoint(str(pth), model_n,
                                                        it_n))
    (model_t, it_t), load_pth_s = timed(
        lambda: mio.load_checkpoint_auto(str(pth), device=dev))
    cam = train_cameras("cam", (0.0,), TRAIN_H, TRAIN_W)[0]
    s = make_settings(cam, model_n.active_sh_degree, 1.0, SCENE_MAX_ENTRIES)
    frames = []
    with torch.no_grad():
        for m in (model_t, model_n):
            frames.append(render(
                s, m, cam.world_view_transform, cam.full_proj_transform,
                cam.camera_center, np.zeros(3, np.float32),
                include_feature=True, topk=TRAIN_TOPK, device=dev))
    (ft, fn) = frames
    equal = all(torch.equal(a, b) for a, b in (
        (ft.render, fn.render),
        (ft.language_feature_weight_map, fn.language_feature_weight_map),
        (ft.final_transmittance, fn.final_transmittance)))
    res["checkpoint"] = dict(
        iteration=it_n, npz_capacity=model_n.capacity,
        pth_capacity=model_t.capacity, load_npz_s=load_npz_s,
        save_npz_s=save_npz_s, save_pth_s=save_pth_s, load_pth_s=load_pth_s,
        frames_equal=equal, frame_total_entries=int(fn.total_entries))
    log(f"phase 21 checkpoint (iteration {it_n}): .npz save "
        f"{save_npz_s:.3f} s, load {load_npz_s:.3f} s; reference .pth save "
        f"{save_pth_s:.3f} s, load {load_pth_s:.3f} s; quick frame from the "
        f".pth model (capacity {model_t.capacity}) equal to the .npz "
        f"model's ({model_n.capacity}): {equal}; launches over the phase "
        f"{res['launches']} ({smi})")
    if it_t != it_n or not equal:
        fail("phase 21: the .pth model's frame differs from the .npz one's")
    if int(fn.total_entries) >= SCENE_MAX_ENTRIES or not bool(
            torch.isfinite(fn.language_feature_weight_map).all()):
        fail("phase 21: the checkpoint frame saturated or is not finite")
    del model_n, model_t, frames, ft, fn
    return res


# ------------- phase 22: score, serve and watch a scene from the command line

CLI_SCENE = "eval_scene"               # <path_root>/<scene>, <scene>_1_<lvl>
CLI_ITER = 30
CLI_WRAPPERS = {"K1": "k1.launches",
                "K1nocull": "k1.nocull_launches",
                "K2": blend.blend_tiles,
                "K2f16": blend.blend_tiles_fast16,
                "K2q": blend.blend_tiles_query, "K3": query.query_map_tiles,
                "K3bf16": query.query_map_tiles_bf16,
                "K7": rgb_train.rgb_grads}
# A concave polygon (a "U" opening downward), offset a frame.
CONCAVE = np.array([[0, 0], [150, 0], [150, 110], [100, 110], [100, 40],
                    [50, 40], [50, 110], [0, 110]])


def rect_polygon(box) -> list:
    """eval_gt's mask [y0:y1, x0:x1] as labelme's 4 vertices: the
    inclusive corners, which cv2.fillPoly fills to exactly that block."""
    x0, y0, x1, y1 = (int(v) for v in box)
    return [[x0, y0], [x1 - 1, y0], [x1 - 1, y1 - 1], [x0, y1 - 1]]


def write_cli_scene(root: Path, gt_ann: dict, cams) -> None:
    """Phase 22's scene: COLMAP sparse/0 of phase 19's cameras (PINHOLE,
    centres at the origin), seeded PNGs, label/frame_0000<j+1>.json in
    labelme form (eval_gt's rectangles as polygons plus one concave
    polygon a frame, "lamp") and segmentations/<image>/<prompt>.png (the
    rectangles and a "wood wall" strip)."""
    from PIL import Image

    from langsplatv2_tpu_torch.scene import colmap

    rng = np.random.default_rng(22)
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    focal = EVAL_H / (2 * math.tan(math.radians(60) / 2))
    colmap.write_intrinsics_binary(str(sparse / "cameras.bin"), {
        1: colmap.ColmapCamera(1, "PINHOLE", EVAL_W, EVAL_H, np.array(
            [focal, focal, EVAL_W / 2, EVAL_H / 2]))})
    colmap.write_extrinsics_binary(str(sparse / "images.bin"), {
        i + 1: colmap.ColmapImage(
            i + 1, np.array([math.cos(math.radians(-deg) / 2), 0.0,
                             math.sin(math.radians(-deg) / 2), 0.0]),
            np.zeros(3), 1, f"{cams[i].image_name}.png")
        for i, deg in enumerate(EVAL_YAWS)})
    colmap.write_points3d_binary(
        str(sparse / "points3D.bin"),
        np.concatenate([rng.uniform(-4, 4, (2000, 2)),
                        rng.uniform(2, 12, (2000, 1))], 1),
        rng.uniform(0, 1, (2000, 3)))
    for sub in ("images", "label"):
        (root / sub).mkdir()
    for j, cam in enumerate(cams):
        Image.fromarray((rng.uniform(size=(EVAL_H, EVAL_W, 3)) * 255).astype(
            np.uint8)).save(root / "images" / f"{cam.image_name}.png")
        ann = gt_ann[str(j)]
        off = rng.integers(0, (EVAL_W - 160, EVAL_H - 120))
        objects = [{"category": p, "bbox": [int(v) for v in a["bboxes"]],
                    "segmentation": rect_polygon(a["bboxes"])}
                   for p, a in ann.items()]
        objects.append({"category": "lamp",
                        "bbox": [int(off[0]), int(off[1]),
                                 int(off[0]) + 150, int(off[1]) + 110],
                        "segmentation": (CONCAVE + off).tolist()})
        name = f"frame_{j + 1:05d}.jpg"
        with open(root / "label" / name.replace(".jpg", ".json"), "w") as f:
            json.dump({"info": {"name": name, "height": EVAL_H,
                                "width": EVAL_W}, "objects": objects}, f)
        seg = root / "segmentations" / cam.image_name
        seg.mkdir(parents=True)
        for p, a in ann.items():
            Image.fromarray(a["mask"].astype(np.uint8) * 255).save(
                seg / f"{p}.png")
        wall = np.zeros((EVAL_H, EVAL_W), np.uint8)
        wall[-EVAL_H // 5:] = 255
        Image.fromarray(wall).save(seg / "wood wall.png")


def run_cli(main, argv) -> tuple[dict, float, dict, list]:
    """A command line's main in process on the default device: (its
    summary, wall s, launches, stdout lines), the counters zeroed just
    before and read just after."""
    import io as pyio

    zero_counts(CLI_WRAPPERS)
    captured = pyio.StringIO()
    stdout, sys.stdout = sys.stdout, captured
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        summary = main(argv)
    finally:
        sys.stdout = stdout
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return summary, wall, read_counts(CLI_WRAPPERS), \
        captured.getvalue().splitlines()


def check_launches(label: str, launches: dict, expect: dict,
                   phase: int = 22) -> None:
    want = {k: expect.get(k, 0) for k in CLI_WRAPPERS}
    if launches != want:
        fail(f"phase {phase} {label}: launches {launches}, expected {want}")


def same_summary(label: str, got: dict, ref: dict, atol: float = 1e-6):
    if got.keys() != ref.keys() or any(
            (got[k] != ref[k]) if isinstance(ref[k], int)
            else not abs(got[k] - ref[k]) <= atol for k in ref):
        fail(f"phase 22 {label}: {got} against {ref} (atol {atol})")


def timed_call(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def gui_client(port: int, cam, result: dict) -> None:
    """The SIBR viewer's side: a request at zero resolution (a minimized
    viewer: no frame; its reply shows the trainer is serving), then three
    for `cam` at full size: the Python SH colours and covariances at
    scaling_modifier 0.8, train=false; neither, train=false; then
    train=true; closes after the last reply. While the trainer waits for
    the next request its launch counters hold still, so each frame's
    launches and round trip are read between requests."""
    import socket

    view = np.array(cam.world_view_transform, np.float32)
    proj = np.array(cam.full_proj_transform, np.float32)
    view[:, 1:3] *= -1                 # the bridge negates them back
    proj[:, 1] *= -1
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=120)

        def recv_exact(n):
            buf = bytearray()
            while len(buf) < n:
                part = s.recv(n - len(buf))
                if not part:
                    raise ConnectionError("the trainer closed the bridge")
                buf += part
            return bytes(buf)

        replies = []
        for size, shs, train_flag, mod in (
                (0, False, False, 1.0), (1, True, False, 0.8),
                (1, False, False, 1.0), (1, False, True, 1.0)):
            msg = json.dumps({
                "resolution_x": cam.image_width * size,
                "resolution_y": cam.image_height * size, "train": train_flag,
                "fov_y": cam.FoVy, "fov_x": cam.FoVx, "z_near": cam.znear,
                "z_far": cam.zfar, "shs_python": shs,
                "rot_scale_python": shs, "keep_alive": True,
                "scaling_modifier": mod,
                "view_matrix": view.reshape(-1).tolist(),
                "view_projection_matrix": proj.reshape(-1).tolist()}).encode()
            zero_counts(CLI_WRAPPERS)
            t0 = time.perf_counter()
            s.sendall(len(msg).to_bytes(4, "little") + msg)
            frame = recv_exact(cam.image_width * cam.image_height * 3 * size)
            ms = (time.perf_counter() - t0) * 1e3
            verify = recv_exact(int.from_bytes(recv_exact(4), "little"))
            replies.append(dict(frame=frame, ms=ms, verify=verify.decode(),
                                shs=shs, mod=mod,
                                launches=read_counts(CLI_WRAPPERS)))
        s.close()
        result["replies"] = replies
    except Exception as e:   # surfaced by the phase
        result["error"] = repr(e)


def cli_path(dev, smi: str, n: int) -> dict:
    """Phase 22: the command lines a user runs on a trained scene, in
    process on the card. Phase 19's three level models (n Gaussians each)
    as .npz checkpoints and phase 19's 4 cameras as a COLMAP scene with
    labelme and mask-folder GT; eval_lerf (quick: equal to evaluate_quick
    called directly, 1e-6; --no-quick: within phase 19's 1e-4 of it),
    eval_3d_ovs and eval_mip_nerf360 (finite summaries), eval_psnr on
    phase 21's geometry checkpoint (equal to evaluate_psnr called
    directly), the render server built by its command line (5 requests at
    986x728 equal to a server built on the merged model), and the training
    command line with --gui on phase 21's scene, a SIBR client served from
    the resumed model (frames within one u8 level of a direct render).
    Launches are counted a run (a GUI frame: between its requests)."""
    import shutil
    import threading

    from langsplatv2_tpu_torch.eval import (eval_3d_ovs, eval_lerf,
                                            eval_mip_nerf360, eval_psnr)
    from langsplatv2_tpu_torch.eval import mip360, ovs, processing
    from langsplatv2_tpu_torch.models import io as mio
    from langsplatv2_tpu_torch.scene.cameras import MiniCam
    from langsplatv2_tpu_torch.scene.scene import Scene
    from langsplatv2_tpu_torch.serve import backend_renderer, network_gui
    from langsplatv2_tpu_torch.train import cli

    root = Path("build") / "chip_smoke_cli"
    shutil.rmtree(root, ignore_errors=True)
    data, ckpt, out = root / "data", root / "ckpt", root / "out"
    res = {"gaussians": n}
    t0 = time.perf_counter()
    models, merged = level_models(n, EVAL_H, EVAL_W, 0, dev)
    dirs = [ckpt / f"{CLI_SCENE}_1_{lvl}" for lvl in (1, 2, 3)]
    for d, m in zip(dirs, models):
        mio.save_checkpoint(str(d / f"chkpnt{CLI_ITER}.npz"), m, None,
                            CLI_ITER)
    del models
    cams = train_cameras("eval", EVAL_YAWS, EVAL_H, EVAL_W)
    gt_rects = eval_gt(7, len(cams), EVAL_H, EVAL_W)
    write_cli_scene(data / CLI_SCENE, gt_rects, cams)
    res["write_s"] = time.perf_counter() - t0

    gt_ann, hw, _ = lerf.eval_gt_lerfdata(str(data / CLI_SCENE / "label"))
    for j, ann in gt_rects.items():
        for p, a in ann.items():
            if not np.array_equal(gt_ann[j][p]["mask"], a["mask"]):
                fail(f"phase 22: the rectangle of {p!r} in frame {j} is "
                     "not its numpy block")
    if hw != (EVAL_H, EVAL_W) or any(
            not gt_ann[j]["lamp"]["mask"].any() for j in gt_ann):
        fail(f"phase 22: labelme GT {hw}")
    res["lamp_pixels"] = [int(gt_ann[j]["lamp"]["mask"].sum())
                          for j in gt_ann]
    res["polygon_ms"] = timed_call(lambda: processing.polygon_to_mask(
        (EVAL_H, EVAL_W), CONCAVE + 100))[1]

    bench = ["--dataset_name", CLI_SCENE, "--path_root", str(data),
             "--ckpt_root", str(ckpt), "--iteration", str(CLI_ITER),
             "--clip_backend", "hash"]
    frames = len(cams)
    runs = {}
    for name, main, argv, expect in (
            ("lerf", eval_lerf.main, ["--output_root", str(out / "q")],
             {"K1": frames, "K2": frames, "K3": frames}),
            ("lerf --no-quick", eval_lerf.main,
             ["--output_root", str(out / "nq"), "--no-quick"],
             {"K1": 3 * frames, "K2": 3 * frames}),
            ("3d_ovs", eval_3d_ovs.main, ["--output_root", str(out / "o")],
             {"K1": frames, "K2": frames, "K3": frames}),
            ("mip_nerf360", eval_mip_nerf360.main,
             ["--output_root", str(out / "m")], {"K1": frames,
                                                 "K2": frames})):
        summary, wall, launches, lines = run_cli(main, bench + argv)
        check_launches(name, launches, expect)
        if not all(math.isfinite(v) for v in summary.values()):
            fail(f"phase 22 {name}: {summary}")
        runs[name] = dict(summary=summary, wall_s=wall, launches=launches,
                          output=lines[-3:])

    # The same inputs through the drivers, timed a frame.
    scene_cams = Scene(str(data / CLI_SCENE), "", eval_split=False,
                       shuffle=False).get_train_cameras()
    clip = OpenCLIPNetwork("hash", device=dev)
    direct, ms = timed_call(lambda: lerf.evaluate_quick(
        merged, scene_cams, gt_ann, hw, clip, mask_thresh=0.4, device=dev))
    runs["lerf"]["frame_ms"] = ms / frames
    same_summary("lerf", runs["lerf"]["summary"], {
        k: direct[k] for k in ("mean_iou", "localization_accuracy")})
    same_summary("lerf --no-quick", runs["lerf --no-quick"]["summary"],
                 runs["lerf"]["summary"], atol=1e-4)
    levels = [mio.load_checkpoint(str(d / f"chkpnt{CLI_ITER}.npz"),
                                  device=dev)[0] for d in dirs]
    runs["lerf --no-quick"]["frame_ms"] = timed_call(lambda: lerf.evaluate(
        levels, scene_cams, gt_ann, hw, clip, device=dev))[1] / frames
    del levels
    ovs_gt, fids = ovs.eval_gt_ovsdata(
        str(data / CLI_SCENE / "segmentations"))
    by_name = {c.image_name: c for c in scene_cams}
    runs["3d_ovs"]["frame_ms"] = timed_call(lambda: ovs.evaluate_quick(
        merged, {f: by_name[f] for f in fids}, ovs_gt, clip,
        device=dev))[1] / frames
    runs["mip_nerf360"]["frame_ms"] = timed_call(lambda: mip360.evaluate_quick(
        merged, scene_cams, gt_ann, hw, clip, device=dev))[1] / frames

    # PSNR of phase 21's geometry checkpoint (--iteration -1: the highest).
    scene21 = Path("build") / "chip_smoke_scene"
    gdir = scene21 / "out" / "g_-1"
    summary, wall, launches, lines = run_cli(
        eval_psnr.main, ["-s", str(scene21 / "scene"), "-m", str(gdir)])
    test_cams = Scene(str(scene21 / "scene"), "", eval_split=True,
                      shuffle=False).get_test_cameras()
    model21, it21 = mio.load_checkpoint_auto(str(gdir / "chkpnt24.npz"),
                                             device=dev)
    (mean, per), ms = timed_call(lambda: psnr_eval.evaluate_psnr(
        model21, test_cams, device=dev))
    check_launches("psnr", launches, {"K1": len(test_cams),
                                      "K2": len(test_cams)})
    same_summary("psnr", summary, {"mean_psnr": mean,
                                   "num_images": len(per)})
    runs["psnr"] = dict(summary=summary, wall_s=wall, launches=launches,
                        frame_ms=ms / len(per), output=lines[-3:],
                        checkpoint=it21)

    # The render server from the three checkpoints against one built on
    # the merged model, five requests at 986x728.
    fovy = math.radians(60)
    fovx = 2 * math.atan(math.tan(fovy / 2) * EVAL_W / EVAL_H)
    reqs = [serve_request(yaw_c2w(4.0 * i, EVAL_W, fovx), EVAL_W, EVAL_H,
                          fovy) for i in range(FRAMES)]
    server, build_ms = timed_call(lambda: backend_renderer.make_server(
        ["--ckpt_paths", *map(str, dirs), "--iteration", str(CLI_ITER),
         "--clip_backend", "hash"], compose="device"))
    direct_server = BackendRenderer(merged, clip_model=OpenCLIPNetwork(
        "hash", device=dev), tile_budget_cap=256, compose="device",
        device=dev)
    timed_request(server, serve_request(yaw_c2w(100.0, EVAL_W, fovx), EVAL_W,
                                        EVAL_H, fovy))   # warm-up
    zero_counts(CLI_WRAPPERS)
    served = [timed_request(server, r) for r in reqs]
    launches = read_counts(CLI_WRAPPERS)
    check_launches("server", launches, {"K1": FRAMES, "K2f16": FRAMES})
    for i, r in enumerate(reqs):
        ref = direct_server.finalize_frame(direct_server.dispatch_request(r),
                                           as_uint8=True)
        if not np.array_equal(served[i][0], ref):
            fail(f"phase 22 server: request {i} differs from the direct "
                 "server's frame")
    runs["server"] = dict(build_ms=build_ms, launches=launches,
                          request_ms=[d + f for _, d, f in served],
                          request_ms_median=statistics.median(
                              d + f for _, d, f in served))
    del server, direct_server, merged, served
    torch.cuda.empty_cache()

    # Training with the viewer: phase 21's geometry checkpoint resumed for
    # 3 iterations with --gui on a free port.
    cam = train_cameras("cam", (0.0,), TRAIN_H, TRAIN_W)[0]
    result = {}

    def client():
        for _ in range(20_000):
            if network_gui.listener is not None:
                break
            time.sleep(0.001)
        else:
            result["error"] = "no listener"
            return
        gui_client(network_gui.listener.getsockname()[1], cam, result)

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    try:
        summary, wall, _, lines = run_cli(cli.main, [
            "-s", str(scene21 / "scene"), "-m", str(out / "gui"),
            "--start_checkpoint", str(gdir / "chkpnt24.npz"),
            "--iterations", "27", "--max_entries", str(SCENE_MAX_ENTRIES),
            "--gui", "--port", "0"])
        thread.join(timeout=120)
    finally:
        if network_gui.listener is not None:
            network_gui.listener.close()
        network_gui.listener = network_gui.conn = None
    if thread.is_alive() or "error" in result:
        fail(f"phase 22 gui: {result.get('error', 'the client hung')}")
    replies = result["replies"]
    check_launches("gui, zero resolution", replies[0]["launches"], {})
    if replies[0]["frame"]:
        fail("phase 22 gui: a frame for a zero-resolution request")
    replies = replies[1:]
    if summary["first_iter"] != 24 or not any(
            "Connected by" in ln for ln in lines):
        fail(f"phase 22 gui: {summary['first_iter']}, {lines[:5]}")
    gui = []
    for rep in replies[:2]:
        mc = MiniCam(cam.image_width, cam.image_height, cam.FoVy, cam.FoVx,
                     cam.znear, cam.zfar, cam.world_view_transform,
                     cam.full_proj_transform)
        with torch.no_grad():
            ref = render(make_settings(mc, model21.active_sh_degree,
                                       rep["mod"], SCENE_MAX_ENTRIES),
                         model21,
                         mc.world_view_transform, mc.full_proj_transform,
                         mc.camera_center, np.zeros(3, np.float32),
                         convert_shs_python=rep["shs"],
                         compute_cov3d_python=rep["shs"], device=dev)
            ref = (torch.clamp(ref.render, 0, 1) * 255).to(torch.uint8)
        ref = ref.permute(1, 2, 0).cpu().numpy().astype(np.int16)
        got = np.frombuffer(rep["frame"], np.uint8).reshape(
            ref.shape).astype(np.int16)
        diff = int(np.abs(got - ref).max())
        # The Python covariances take the XLA route (K1 without the cull,
        # the autograd tile blend), as JAX's viewer does.
        check_launches("gui frame", rep["launches"],
                       {"K1": 1, "K1nocull": 1} if rep["shs"]
                       else {"K1": 1, "K2": 1})
        gui.append(dict(ms=rep["ms"], max_level_diff=diff, shs=rep["shs"],
                        launches=rep["launches"], mean=float(got.mean())))
        if diff > 1 or got.max() == 0:
            fail(f"phase 22 gui: frame differs by {diff} levels from the "
                 "direct render (or is black)")
    if any(rep["verify"] != os.path.abspath(scene21 / "scene")
           for rep in result["replies"]):
        fail("phase 22 gui: verify strings "
             f"{[r['verify'] for r in result['replies']]}")
    runs["gui"] = dict(frames=gui, wall_s=wall, last_iter=summary["last_iter"],
                       losses=summary["losses"])
    res["runs"] = runs
    del model21
    torch.cuda.empty_cache()
    log(f"phase 22 ({n} Gaussians a level, {EVAL_W}x{EVAL_H}; {smi}): "
        + "; ".join(f"{k} {r.get('summary', '')} wall {r.get('wall_s', 0):.2f}"
                    f" s, {r.get('frame_ms', float('nan')):.2f} ms a frame, "
                    f"launches {r.get('launches', '')}"
                    for k, r in runs.items() if k not in ("server", "gui")))
    log(f"phase 22 server: built from checkpoints in "
        f"{runs['server']['build_ms']:.1f} ms, request median "
        f"{runs['server']['request_ms_median']:.3f} ms, equal to the direct "
        f"server's frames; gui: frames "
        + ", ".join(f"{g['ms']:.1f} ms (shs/cov {g['shs']}, max diff "
                    f"{g['max_level_diff']})" for g in gui)
        + f", run {wall:.1f} s ({smi})")
    return res


# ------------- phase 23: the XLA route (impl="xla") on the card

XLA_WRAPPERS = {"K1": "k1.launches",
                "K1nocull": "k1.nocull_launches",
                "K2": blend.blend_tiles, "K2dense": blend.blend_tiles_dense,
                "K4": train.feature_grads, "K5": train.feature_grads_topk,
                "K6a": gram.gram_tiles_fwd, "K6b": gram.gram_tiles_bwd,
                "K7": rgb_train.rgb_grads, "K8": cascade.cascade_binning}
XLA_STEPS = 20
# scripts/profile_rgb_train.py:62-66 runs the XLA step at tile_cap 512:
# the autograd blend keeps [tile_batch, 256, tile_cap] temporaries a batch.
XLA_TILE_CAP = 512
XLA_MAX_ENTRIES = 2 ** 22
XLA_CLI_MAX_ENTRIES = 2 ** 24   # phase 21's wide splats without the cull
# The cross-check's scene: small enough for the per-pixel oracle's
# [pixels, N] temporaries under autograd, every tile within tile_cap.
CROSS_N, CROSS_H, CROSS_W = 3000, 128, 160
# f32 tolerances: the oracle and the route (images, gradients of the
# largest), the kernel routes and the route.
CROSS_ATOL, CROSS_GRAD_REL, CROSS_KERNEL_ATOL = 1e-5, 2e-5, 3e-5


def check_xla_launches(label: str, launches: dict, expect: dict) -> None:
    want = {k: expect.get(k, 0) for k in XLA_WRAPPERS}
    if launches != want:
        fail(f"phase 23 {label}: launches {launches}, expected {want}")


def k1_nocull(dev) -> dict:
    """Phase 23 (a): K1 without the exact cull (the XLA route's binning) on
    phase 4's bench scene at 1080p, on the route's own inputs (the
    preprocess without opacities: 3-sigma tile rects): tile, depth, gauss
    and total against its plain version bit for bit, at a budget above the
    live total and at one that cuts it; timed beside K1 with the cull on
    the kernel route's inputs (phase 5's) and beside bin_gaussians (K1 +
    the key sort). Bound: 12 B a Gaussian (tiles_touched, the scan), 20 B
    an on-screen one (its rect and depth; no cull reads xy, conic or
    opacity), 12 B a slot written."""
    model = from_numpy_params(bench_scene(1_000_000), device=dev)
    h, w = 1080, 1920
    view, pm, tfx, tfy = bench_camera(h, w)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    with torch.no_grad():
        op = model.get_opacity()[:, 0].contiguous()
        geo = (model.xyz, model.get_scaling(), model.get_rotation(), None,
               None, T(view), T(pm), torch.zeros(3, device=dev), tfx, tfy,
               w, h, 0)
        proj = projection.preprocess(*geo)
        proj_k = projection.preprocess(*geo, opacities=op)
    del model
    gx, gy = -(-w // 16), -(-h // 16)
    n = op.shape[0]
    live = int(proj.tiles_touched.sum())
    n_on = int((proj.tiles_touched > 0).sum())
    offsets = torch.cumsum(proj.tiles_touched, 0, dtype=torch.int64) \
        - proj.tiles_touched
    inv = float(np.float32(255.0))
    budgets = {"above": (int(live * 1.07) // (1 << 20) + 1) * (1 << 20),
               "cut": live // 2 + 777}
    res = {"live_total": live, "gaussians_on_screen": n_on,
           "kernel_route_total": int(proj_k.tiles_touched.sum())}
    for name, budget_ in budgets.items():
        out = expand.expand_entries(proj, op, gx, gy, budget_,
                                    exact_cull=False)
        ref = expand.expand_entries_plain(proj, op, offsets, gx, gy, budget_,
                                          False, inv)
        pairs = list(zip(out[:3], ref))
        mism = sum(int((a != b).sum()) for a, b in pairs)
        res[name] = dict(max_entries=budget_, mismatches=mism,
                         total=int(out[3]), max_abs_err=max_diff(pairs))
        if mism or int(out[3]) != min(live, budget_):
            fail(f"phase 23 (a): K1 without the cull differs from its plain "
                 f"version at max_entries {budget_}: {mism} entries, total "
                 f"{int(out[3])} of {live}")
        del out, ref, pairs
    budget_ = budgets["above"]
    ms, _ = cuda_ms(lambda: expand.expand_entries(
        proj, op, gx, gy, budget_, exact_cull=False), 20)
    plain_ms, _ = cuda_ms(lambda: expand.expand_entries_plain(
        proj, op, offsets, gx, gy, budget_, False, inv), 3)
    cull_ms, _ = cuda_ms(lambda: expand.expand_entries(
        proj_k, op, gx, gy, LOADS[0][3]), 20)
    bin_ms, _ = cuda_ms(lambda: binning.bin_gaussians(proj, gx, gy, budget_,
                                                      op), 10)
    b_ms, b_by = bound(n * 12 + n_on * 20 + budget_ * 12, 0.0)
    res["row"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                      bound_ms=b_ms, bound_by=b_by,
                      max_abs_err=max(res[k]["max_abs_err"]
                                      for k in budgets))
    res.update(cull_ms=cull_ms, bin_gaussians_ms=bin_ms)
    log(f"phase 23 (a) K1 without the cull, 1080p bench scene: {live} "
        f"entries ({res['kernel_route_total']} in the kernel route's "
        f"rects), equal to its plain version at max_entries "
        f"{budgets['above']} and {budgets['cut']}; {ms:.4f} ms (bound "
        f"{b_ms:.4f}, {b_by}; plain {plain_ms:.3f}) beside K1 with the cull "
        f"{cull_ms:.4f} ms on the kernel route's inputs; bin_gaussians "
        f"{bin_ms:.3f} ms")
    return res


def xla_step_path(dev, smi: str) -> dict:
    """Phase 23 (b): the geometry step through impl="xla" at full width
    (phase 9's SH 3 scene: 300k Gaussians, 544x960, its 4 cameras), at
    tile_cap 512 and tile_batch 16: train_rgb for 20 steps, the counters
    zeroed just before and read just after (K1 without the cull once a
    step, no kernel of the kernel routes), the median step, the peak
    device memory, the loss (finite, falling) and finite gradients; then
    one step's forward and backward timed apart."""
    model, images = rgb_scene(RGB_N, TRAIN_H, TRAIN_W, len(TRAIN_YAW_DEG), 0,
                              dev)
    cams = train_cameras("xla", TRAIN_YAW_DEG, TRAIN_H, TRAIN_W, images)
    opt = OptimizationParams(argparse.ArgumentParser())
    step_ms, metrics_log = [], []
    clock = [None]

    def on_iteration(it, m, _opt, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - clock[0]) * 1e3)
        clock[0] = now
        metrics_log.append(dict(
            loss=float(metrics["loss"]),
            total_entries=int(metrics["total_entries"]),
            max_tile_count=int(metrics["max_tile_count"])))

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    zero_counts(XLA_WRAPPERS)
    clock[0] = time.perf_counter()
    model, _, logs = trainer.train_rgb(
        model, cams, opt, RGB_EXTENT, iterations=XLA_STEPS, seed=0,
        tile_cap=XLA_TILE_CAP, max_entries=XLA_MAX_ENTRIES, impl="xla",
        on_iteration=on_iteration, device=dev)
    launches = read_counts(XLA_WRAPPERS)
    peak = torch.cuda.max_memory_allocated()
    losses_ = logs.losses
    finite = all(bool(torch.isfinite(getattr(model, k).grad).all())
                 for k in trainer.RGB_PARAM_NAMES)
    tot = [m["total_entries"] for m in metrics_log]
    mtc = [m["max_tile_count"] for m in metrics_log]
    check_xla_launches("(b) geometry steps", launches,
                       {"K1": XLA_STEPS, "K1nocull": XLA_STEPS})
    if not (all(math.isfinite(v) for v in losses_) and finite):
        fail(f"phase 23 (b): non-finite loss or gradients: {losses_}")
    if not statistics.mean(losses_[-4:]) < statistics.mean(losses_[:4]):
        fail(f"phase 23 (b): the loss did not fall: {losses_}")
    if max(tot) >= XLA_MAX_ENTRIES:
        fail(f"phase 23 (b): the entry budget saturated: {tot}")

    # One step's forward (render and loss) and backward, timed apart.
    cam = cams[0]
    s = make_settings(cam, model.active_sh_degree, 1.0, XLA_MAX_ENTRIES,
                      XLA_TILE_CAP, 16, impl="xla")
    gt = torch.as_tensor(cam.image, device=dev)
    split = []
    for _ in range(3):
        dummy = torch.zeros((model.capacity, 2), device=dev,
                            requires_grad=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = render(s, model, cam.world_view_transform,
                     cam.full_proj_transform, cam.camera_center,
                     np.zeros(3, np.float32), means2d_dummy=dummy, device=dev)
        loss = 0.8 * losses.l1_loss(out.render, gt) + 0.2 * (
            1.0 - losses.ssim(out.render, gt))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        split.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
        for k in trainer.RGB_PARAM_NAMES:
            getattr(model, k).grad = None
    fwd_ms = statistics.median(a for a, _ in split)
    bwd_ms = statistics.median(b for _, b in split)
    res = dict(step_ms=step_ms, step_ms_median=statistics.median(step_ms),
               peak_bytes=peak, base_bytes=base_mem, losses=losses_,
               total_entries=tot, max_tile_count=mtc, launches=launches,
               forward_ms=fwd_ms, backward_ms=bwd_ms,
               tile_cap=XLA_TILE_CAP)
    log(f"phase 23 (b) geometry step through impl=\"xla\" ({RGB_N} "
        f"Gaussians, SH 3, {TRAIN_W}x{TRAIN_H}, tile_cap {XLA_TILE_CAP}, "
        f"tile_batch 16): median {res['step_ms_median']:.3f} ms a step over "
        f"{XLA_STEPS} (forward {fwd_ms:.3f}, backward {bwd_ms:.3f}); peak "
        f"{peak / 2**30:.3f} GiB allocated ({base_mem / 2**30:.3f} before); "
        f"loss first {losses_[0]!r} last {losses_[-1]!r}; entries "
        f"{max(tot)}, max tile count {max(mtc)}; launches {launches} "
        f"({smi})")
    del model, cams, images
    return res


def cross_scene(dev) -> dict:
    """The cross-check's tensors: CROSS_N Gaussians in front of the bench
    camera, SH 3, 64 dense channels and 12 quick pairs over 192 channels,
    from a seed."""
    rng = np.random.default_rng(23)
    n = CROSS_N
    shs = (rng.normal(size=(n, 16, 3)) * 0.3).astype(np.float32)
    shs[:, 0] = rng.uniform(0.1, 1.5, (n, 3))
    qw = rng.uniform(0, 1, (n, L * TOPK)).astype(np.float32)
    qw /= qw.sum(1, keepdims=True)
    qi = np.concatenate([rng.integers(0, K, (n, TOPK)) + lvl * K
                         for lvl in range(L)], 1).astype(np.float32)
    arrays = dict(
        means3d=np.concatenate([rng.uniform(-2, 2, (n, 2)),
                                rng.uniform(2.0, 8.0, (n, 1))], 1),
        scales=rng.uniform(0.02, 0.2, (n, 3)),
        rotations=rng.normal(size=(n, 4)),
        opacities=rng.uniform(0.2, 0.95, (n, 1)), shs=shs,
        features=rng.uniform(0, 1, (n, 64)), quick_weights=qw)
    out = {k: torch.as_tensor(v.astype(np.float32), device=dev)
           for k, v in arrays.items()}
    out["quick_indices"] = torch.as_tensor(qi, device=dev)
    return out


def xla_cross_check(dev) -> dict:
    """Phase 23 (c): on a reduced scene (CROSS_N Gaussians at
    CROSS_W x CROSS_H, every tile within tile_cap), the same inputs through
    the XLA route, the per-pixel oracle on the card and the kernel routes
    (impl="pallas"): RGB at SH 3 with a background and the means2D carrier
    (K7's gradients), 64 dense channels (K2 dense, K4) and 192 quick
    channels with quick_train (K2 f32, K4). The route against the oracle:
    images atol 1e-5, the gradients of every input 2e-5 of the largest;
    against the kernel routes: images atol 3e-5, the gradients the kernel
    route gives 2e-5 of the largest."""
    view, pm, tfx, tfy = bench_camera(CROSS_H, CROSS_W)
    bg = torch.tensor([0.2, 0.5, 0.8], device=dev)
    zero3 = torch.zeros(3, device=dev)
    base = cross_scene(dev)
    rng = np.random.default_rng(24)
    weights = {k: torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                  device=dev)
               for k, shape in (("rgb", (3, CROSS_H, CROSS_W)),
                                ("t", (CROSS_H, CROSS_W)),
                                ("f64", (64, CROSS_H, CROSS_W)),
                                ("f192", (L * K, CROSS_H, CROSS_W)))}
    geo_names = ("means3d", "scales", "rotations", "opacities")
    res = {}
    for mode in ("rgb", "dense", "quick"):
        sh = 3 if mode == "rgb" else 0
        s = RasterizeSettings(CROSS_H, CROSS_W, tfx, tfy, sh,
                              max_entries=1 << 18, impl="xla")
        names = geo_names + ("shs", "means2d_dummy") + (
            ("features",) if mode == "dense" else ()) + (
            ("quick_weights",) if mode == "quick" else ())
        outs = {}
        for route in ("xla", "oracle", "kernel"):
            t = {k: base[k].clone().requires_grad_(True) for k in names
                 if k != "means2d_dummy"}
            t["means2d_dummy"] = torch.zeros((CROSS_N, 2), device=dev,
                                             requires_grad=True)
            shs = t["shs"] if mode == "rgb" else t["shs"][:, :1]
            kw = {}
            if mode == "dense":
                kw["features"] = t["features"]
            if mode == "quick":
                kw = dict(quick_weights=t["quick_weights"],
                          quick_indices=base["quick_indices"].int(),
                          quick_channels=L * K, quick_train=True)
            carrier = t["means2d_dummy"] if (mode == "rgb"
                                             or route != "kernel") else None
            if route == "oracle":
                feats = kw.get("features")
                if mode == "quick":
                    feats = torch.zeros((CROSS_N, L * K), device=dev
                                        ).scatter_add(
                        1, base["quick_indices"].long(), t["quick_weights"])
                rgb, feat, radii, tt = rasterize_reference(
                    t["means3d"], t["opacities"], t["scales"],
                    t["rotations"], None, shs, None, feats, view, pm, zero3,
                    tfx, tfy, CROSS_W, CROSS_H, sh, bg,
                    means2d_dummy=carrier, device=dev)
                mtc = None
            else:
                o = rasterize(
                    s._replace(impl="xla" if route == "xla" else "pallas"),
                    t["means3d"], t["opacities"], view, pm, zero3, bg,
                    scales=t["scales"], rotations=t["rotations"], shs=shs,
                    means2d_dummy=carrier, device=dev, **kw)
                rgb, feat, tt, mtc = (o.rgb, o.feature_map,
                                      o.final_transmittance,
                                      int(o.max_tile_count))
            loss = (rgb * weights["rgb"]).sum() + (tt * weights["t"]).sum()
            if feat is not None:
                loss = loss + (feat * weights[
                    "f64" if mode == "dense" else "f192"]).sum()
            loss.backward()
            outs[route] = dict(
                images=[x.detach() for x in (rgb, tt) + (
                    (feat,) if feat is not None else ())],
                grads={k: v.grad for k, v in t.items()
                       if v.grad is not None}, max_tile_count=mtc)
        if outs["xla"]["max_tile_count"] > s.tile_cap:
            fail(f"phase 23 (c) {mode}: a tile holds "
                 f"{outs['xla']['max_tile_count']} entries, past tile_cap")
        r = {"max_tile_count": outs["xla"]["max_tile_count"]}
        for other, atol in (("oracle", CROSS_ATOL),
                            ("kernel", CROSS_KERNEL_ATOL)):
            img = max(float((a - b).abs().max()) for a, b in zip(
                outs["xla"]["images"], outs[other]["images"]))
            grads = {}
            for k, b in outs[other]["grads"].items():
                scale = float(b.abs().max()) + 1e-12
                grads[k] = float((outs["xla"]["grads"][k] - b).abs().max()
                                 ) / scale
            r[other] = dict(image_err=img, grad_rel_err=grads)
            if not img <= atol or not all(v <= CROSS_GRAD_REL
                                          for v in grads.values()):
                fail(f"phase 23 (c) {mode}: the XLA route against the "
                     f"{other}: images {img} (atol {atol}), gradients "
                     f"{grads} (of the largest, {CROSS_GRAD_REL})")
            if other == "kernel" and not grads:
                fail(f"phase 23 (c) {mode}: no kernel-route gradient")
        res[mode] = r
        log(f"phase 23 (c) {mode} ({CROSS_N} Gaussians, {CROSS_W}x"
            f"{CROSS_H}, max tile count {r['max_tile_count']}): the XLA "
            f"route against the oracle: images {r['oracle']['image_err']!r}"
            f", gradients {r['oracle']['grad_rel_err']}; against the kernel "
            f"route: images {r['kernel']['image_err']!r}, gradients "
            f"{r['kernel']['grad_rel_err']}")
    return res


def dense_auto_step(dev, smi: str) -> dict:
    """Phase 23 (d): dense features (the top-4 weights, 64 channels) with a
    geometry gradient under impl="auto" on phase 7's scene at 544x960: one
    step (the XLA route: K1 without the cull, no dense K2 or K4) timed,
    with its peak memory and finite, non-zero gradients of means, scales,
    rotations, opacities and features; then an RGB frame on
    binning="cascade" under impl="auto" (the XLA route, not K8) equal to
    the impl="xla" frame bit for bit."""
    model, _ = train_scene(TRAIN_N, 0, dev)
    cam = train_cameras("dense", (0.0,), TRAIN_H, TRAIN_W)[0]
    s = make_settings(cam, 0, 1.0, XLA_MAX_ENTRIES)
    view, pm, campos = (cam.world_view_transform, cam.full_proj_transform,
                        cam.camera_center)
    with torch.no_grad():
        fields = dict(means3d=model.xyz, scales=model.get_scaling(),
                      rotations=model.get_rotation(),
                      opacities=model.get_opacity(),
                      features=model.get_render_weights(TRAIN_TOPK))
    t = {k: v.detach().clone().requires_grad_(True)
         for k, v in fields.items()}
    shs = model.get_features().detach()
    rng = np.random.default_rng(25)
    cot = torch.as_tensor(rng.normal(size=(K, TRAIN_H, TRAIN_W)).astype(
        np.float32), device=dev)
    z = np.zeros(3, np.float32)
    runs = []
    for _ in range(2):      # the first also warms the allocator
        for v in t.values():
            v.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(XLA_WRAPPERS)
        t0 = time.perf_counter()
        out = rasterize(s, t["means3d"], t["opacities"], view, pm, campos, z,
                        scales=t["scales"], rotations=t["rotations"],
                        shs=shs, features=t["features"], device=dev)
        ((out.feature_map * cot).sum() + out.rgb.sum()).backward()
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t0) * 1e3,
                     torch.cuda.max_memory_allocated(),
                     read_counts(XLA_WRAPPERS)))
    ms, peak, launches = runs[-1]
    check_xla_launches("(d) dense step", launches, {"K1": 1, "K1nocull": 1})
    bad = [k for k, v in t.items() if not (
        bool(torch.isfinite(v.grad).all()) and float(v.grad.abs().max()) > 0)]
    if bad:
        fail(f"phase 23 (d): non-finite or zero gradients of {bad}")
    with torch.no_grad():
        zero_counts(XLA_WRAPPERS)
        frames = [rasterize(s._replace(**change), t["means3d"],
                            t["opacities"], view, pm, campos, z,
                            scales=t["scales"], rotations=t["rotations"],
                            shs=shs, device=dev)
                  for change in (dict(binning="cascade"), dict(impl="xla"))]
        frame_launches = read_counts(XLA_WRAPPERS)
    check_xla_launches("(d) cascade frame under auto", frame_launches,
                       {"K1": 2, "K1nocull": 2})
    equal = all(torch.equal(getattr(frames[0], f), getattr(frames[1], f))
                for f in ("rgb", "final_transmittance", "max_tile_count",
                          "total_entries"))
    if not equal:
        fail("phase 23 (d): the cascade frame under impl=\"auto\" differs "
             "from the impl=\"xla\" frame")
    res = dict(ms=ms, first_ms=runs[0][0], peak_bytes=peak,
               launches=launches, total_entries=int(out.total_entries),
               max_tile_count=int(out.max_tile_count), cascade_equal=equal)
    log(f"phase 23 (d) dense features (64 channels) with geometry gradients "
        f"under impl=\"auto\" ({TRAIN_N} Gaussians, {TRAIN_W}x{TRAIN_H}, "
        f"tile_cap {s.tile_cap}): one step {ms:.3f} ms (first "
        f"{runs[0][0]:.3f}), peak {peak / 2**30:.3f} GiB, "
        f"{res['total_entries']} entries, max tile count "
        f"{res['max_tile_count']}; launches {launches}; the RGB cascade "
        f"frame under auto equals the impl=\"xla\" frame ({smi})")
    del model, t, out, frames
    return res


def xla_cli(dev, smi: str, scene_res: dict) -> dict:
    """Phase 23 (e): `train.cli --impl xla --tile_cap 512` on phase 21's
    scene directory, in process: 8 geometry iterations from the points and
    8 feature iterations from phase 21's geometry checkpoint (k-means
    codebooks, --cos_loss --topk 4), each counted (K1 without the cull
    once an iteration, nothing else), finite losses, the ms a camera
    beside phase 21's kernel-route runs and the peak memory."""
    import io as pyio

    from langsplatv2_tpu_torch.train import cli

    root = Path("build") / "chip_smoke_scene"
    scene, out = root / "scene", root / "out"
    base = ["-s", str(scene), "--max_entries", str(XLA_CLI_MAX_ENTRIES),
            "--impl", "xla", "--tile_cap", str(XLA_TILE_CAP)]
    runs = {
        "geometry": (["-m", str(out / "xg"), "--iterations", "8"],
                     "geometry"),
        "feature": (["-m", str(out / "xf"), "--include_feature",
                     "--start_checkpoint",
                     str(out / "g_-1" / "chkpnt24.npz"), "--feature_level",
                     "1", "--cos_loss", "--topk", "4", "--iterations", "8"],
                    "a")}
    res = {}
    for name, (argv, kernel_run) in runs.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(XLA_WRAPPERS)
        captured = pyio.StringIO()
        stdout, sys.stdout = sys.stdout, captured
        t0 = time.perf_counter()
        try:
            summary = cli.main(base + argv)
        finally:
            sys.stdout = stdout
        wall = time.perf_counter() - t0
        launches = read_counts(XLA_WRAPPERS)
        check_xla_launches(f"(e) {name}", launches, {"K1": 8, "K1nocull": 8})
        losses_ = summary["losses"]
        if not all(math.isfinite(v) for v in losses_):
            fail(f"phase 23 (e) {name}: non-finite loss {losses_}")
        if max(summary["total_entries"]) >= XLA_CLI_MAX_ENTRIES:
            fail(f"phase 23 (e) {name}: the expansion reached max_entries")
        kernel_ms = scene_res["runs"][kernel_run]["ms_per_camera"]
        r = dict(ms_per_camera=statistics.median(summary["iteration_ms"]),
                 kernel_route_ms_per_camera=kernel_ms, wall_s=wall,
                 losses=losses_, launches=launches,
                 peak_bytes=torch.cuda.max_memory_allocated(),
                 total_entries_max=max(summary["total_entries"]))
        res[name] = r
        log(f"phase 23 (e) train.cli --impl xla, {name}: "
            f"{r['ms_per_camera']:.3f} ms a camera (phase 21's kernel route "
            f"{kernel_ms:.3f}), loss first {losses_[0]!r} last "
            f"{losses_[-1]!r}, {r['total_entries_max']} entries, peak "
            f"{r['peak_bytes'] / 2**30:.3f} GiB, {wall:.1f} s in all; "
            f"launches {launches} ({smi})")
    return res


def tools_path(dev, smi: str) -> dict:
    """Phase 23 (f): the render tools on phase 22's level checkpoints and
    scene (986x728), in process: demo_prompt over every 2nd camera (its
    PNGs equal to the frames it computes; their RGB and similarity equal
    to a direct render, render_language_feature_map_quick and the
    script's contrast), debug_renderer on the first level checkpoint (its
    RGB and similarity panels equal to direct renders); each counted."""
    from PIL import Image

    from langsplatv2_tpu_torch.eval.colormaps import apply_jet_u8
    from langsplatv2_tpu_torch.models import io as mio
    from langsplatv2_tpu_torch.scene.scene import Scene
    from langsplatv2_tpu_torch.tools import debug_renderer, demo_prompt

    root = Path("build") / "chip_smoke_cli"
    data = root / "data" / CLI_SCENE
    dirs = [root / "ckpt" / f"{CLI_SCENE}_1_{lvl}" for lvl in (1, 2, 3)]
    prompt = EVAL_PROMPTS[0]
    (paths, wall, launches, _) = run_cli(demo_prompt.main, [
        "--ckpt_paths", *map(str, dirs), "--iteration", str(CLI_ITER),
        "--source_path", str(data), "--prompt", prompt, "--every", "2",
        "--output_dir", str(root / "demo"), "--clip_backend", "hash"])
    check_launches("(f) demo_prompt", launches,
                   {"K1": 2 * len(paths), "K2": 2 * len(paths)}, 23)
    cams = Scene(str(data), "", shuffle=False).get_train_cameras()[::2]
    merged = lerf.merge_level_models(
        [mio.load_checkpoint(str(d / f"chkpnt{CLI_ITER}.npz"),
                             device=dev)[0] for d in dirs])
    clip = OpenCLIPNetwork("hash", device=dev)

    def unit_text(prompts):     # the tools' normalization, in numpy
        e = clip.encode_text(prompts).cpu().numpy()
        return e / np.linalg.norm(e, axis=-1, keepdims=True)

    text = unit_text([prompt])[0]
    bg = np.zeros(3, np.float32)
    diffs = []
    for path, cam in zip(paths, cams):
        mine = demo_prompt.heatmap_frame(merged, cam, text, 0.22,
                                         device=dev)
        s = make_settings(cam, merged.active_sh_degree)
        pose = (cam.world_view_transform, cam.full_proj_transform,
                cam.camera_center)
        with torch.no_grad():
            rgb = torch.clamp(render(s, merged, *pose, bg, device=dev)
                              .render.permute(1, 2, 0), 0, 1).cpu().numpy()
            lf = lerf.render_language_feature_map_quick(
                merged, s, *pose, bg, device=dev).sum(0)
            lf = lf / (torch.linalg.norm(lf, dim=0, keepdim=True) + 1e-10)
            sim = torch.einsum("dhw,d->hw", lf, torch.as_tensor(
                text, device=dev)).cpu().numpy()
        sim = np.clip(sim, 0, 1) ** 4
        sim = np.where(sim > 0.22 ** 4, sim, 0.0)
        if sim.max() > 0:
            sim = sim / sim.max()
        heat = apply_jet_u8((sim * 255).astype(np.uint8)) / 255.0
        frame = (np.where(sim[..., None] > 0, rgb * 0.4 + heat * 0.6, rgb)
                 * 255).astype(np.uint8)
        png = np.asarray(Image.open(path))
        diffs.append(float(np.abs(mine["sim"] - sim).max()))
        if not (np.array_equal(png, mine["frame"])
                and np.array_equal(png, frame)
                and np.array_equal(mine["rgb"], rgb) and diffs[-1] == 0.0):
            fail(f"phase 23 (f): demo_prompt's {path} differs from a direct "
                 f"render (sim {diffs[-1]})")
    del merged
    ckpt = dirs[0] / f"chkpnt{CLI_ITER}.npz"
    prompts = list(EVAL_PROMPTS[:2])
    (dbg, dbg_wall, dbg_launches, _) = run_cli(debug_renderer.main, [
        "--checkpoint", str(ckpt), "--source_path", str(data),
        "--prompts", *prompts, "--output", str(root / "debug.png"),
        "--clip_backend", "hash"])
    check_launches("(f) debug_renderer", dbg_launches, {"K1": 2, "K2": 2},
                   23)
    model, _ = mio.load_checkpoint(str(ckpt), device=dev)
    cam = Scene(str(data), "", shuffle=False).get_train_cameras()[0]
    s = make_settings(cam, model.active_sh_degree)
    pose = (cam.world_view_transform, cam.full_proj_transform,
            cam.camera_center)
    text = torch.as_tensor(unit_text(prompts), device=dev)
    with torch.no_grad():
        rgb = torch.clamp(render(s, model, *pose, bg, device=dev)
                          .render.permute(1, 2, 0), 0, 1).cpu().numpy()
        wmap = render(s, model, *pose, bg, include_feature=True, topk=4,
                      device=dev).language_feature_weight_map
        feat = model.compute_final_feature_map(wmap)
        feat = feat / (torch.linalg.norm(feat, dim=0, keepdim=True) + 1e-10)
        sims = torch.einsum("dhw,pd->hwp", feat, text).cpu().numpy()
    panels = dbg["panels"]
    if not (np.array_equal(panels["rgb"], rgb)
            and np.array_equal(panels["sims"], sims)
            and os.path.exists(root / "debug.png")):
        fail("phase 23 (f): debug_renderer's panels differ from direct "
             "renders")
    del model
    res = dict(demo_frames=len(paths), demo_wall_s=wall,
               demo_launches=launches, demo_sim_diff=max(diffs),
               debug_wall_s=dbg_wall, debug_launches=dbg_launches,
               logit_stats=dbg["logit_stats"])
    log(f"phase 23 (f) demo_prompt: {len(paths)} frames in {wall:.2f} s, "
        f"equal to direct renders, launches {launches}; debug_renderer: "
        f"{dbg_wall:.2f} s, panels equal to direct renders, launches "
        f"{dbg_launches} ({smi})")
    return res


def xla_route_path(dev, smi: str, scene_res: dict) -> dict:
    """Phase 23: (a) to (f) above."""
    t0 = time.perf_counter()
    res = dict(k1_nocull=k1_nocull(dev))
    torch.cuda.empty_cache()
    res["step"] = xla_step_path(dev, smi)
    torch.cuda.empty_cache()
    res["cross_check"] = xla_cross_check(dev)
    torch.cuda.empty_cache()
    res["dense_auto"] = dense_auto_step(dev, smi)
    torch.cuda.empty_cache()
    res["cli"] = xla_cli(dev, smi, scene_res)
    torch.cuda.empty_cache()
    res["tools"] = tools_path(dev, smi)
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 23: {res['phase_s']:.1f} s")
    return res


# ------------- phase 24: preprocess a scene on the card (no new kernel)

PRE_H, PRE_W = 1080, 1440            # the height load_images caps at
# Random SAM weights pass none of the default thresholds (predicted IoU
# 0.7, stability 0.85, area 100): open them as tests/test_sam_jax.py:51-54
# does.
PRE_OPEN = dict(pred_iou_thresh=-1e9, stability_score_thresh=0.0,
                min_mask_region_area=1)
PRE_TINY_REL = 1e-4                  # tiny SAM on the card against the CPU
PRE_GRAM_MASKS = 256                 # candidate masks in (c)'s product
PRE_ROOT = Path("build") / "chip_smoke_preprocess"


def synthetic_photo(seed: int, h: int = PRE_H, w: int = PRE_W) -> np.ndarray:
    """A dark noisy frame with 12 flat coloured rectangles."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 40, (h, w, 3)).astype(np.uint8)
    for _ in range(12):
        y0, x0 = int(rng.integers(0, h - 64)), int(rng.integers(0, w - 64))
        y1 = int(rng.integers(y0 + 32, min(h, y0 + h // 2)))
        x1 = int(rng.integers(x0 + 32, min(w, x0 + w // 2)))
        img[y0:y1, x0:x1] = rng.integers(60, 256, 3)
    return img


def sam_vit_h(dev, seed: int = 0):
    """SAM at VIT_H width, N(0, 0.02) weights from a seeded generator."""
    from langsplatv2_tpu_torch.preprocess import sam

    with torch.device(dev):
        model = sam.Sam(sam.VIT_H)
    return sam.init_weights(
        model, torch.Generator(device=dev).manual_seed(seed)).eval()


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def sam_encoder_check(dev, smi: str):
    """Phase 24 (a): the ViT-H encoder on one 1024^2 input, median of 3
    after a warm-up (TF32 off, as the run sets it, and on), peak memory;
    the same modules at VIT_TINY_TEST on the card against the CPU."""
    import copy

    from langsplatv2_tpu_torch.preprocess import sam

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = sam_vit_h(dev)
    x = torch.randn((1024, 1024, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    res = {}
    with torch.no_grad():
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            ms = [cuda_ms(lambda: model.encode_image(x), 1)[0]
                  for _ in range(3)]
            res["encoder_ms_tf32" if tf32 else "encoder_ms"] = \
                statistics.median(ms)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        emb = model.encode_image(x)
    if emb.shape != (64, 64, 256) or not bool(torch.isfinite(emb).all()):
        fail(f"phase 24 (a): the ViT-H embedding {tuple(emb.shape)} is not "
             "a finite [64, 64, 256]")
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["params"] = sum(p.numel() for p in model.parameters())

    tiny = sam.init_weights(sam.Sam(sam.VIT_TINY_TEST),
                            torch.Generator().manual_seed(2)).eval()
    tiny_dev = copy.deepcopy(tiny).to(dev)
    g = torch.Generator().manual_seed(3)
    xt = torch.randn((64, 64, 3), generator=g)
    pts = torch.rand((8, 1, 2), generator=g)
    labels = torch.ones(8, 1)
    with torch.no_grad():
        e_cpu = tiny.encode_image(xt)
        e_dev = tiny_dev.encode_image(xt.to(dev)).cpu()
        m_cpu, i_cpu = tiny.decode_masks(e_cpu, pts, labels)
        m_dev, i_dev = tiny_dev.decode_masks(e_cpu.to(dev), pts.to(dev),
                                             labels.to(dev))
    res["tiny_rel_err"] = dict(embedding=rel_err(e_dev, e_cpu),
                               logits=rel_err(m_dev.cpu(), m_cpu),
                               iou=rel_err(i_dev.cpu(), i_cpu))
    if max(res["tiny_rel_err"].values()) > PRE_TINY_REL:
        fail(f"phase 24 (a): VIT_TINY_TEST on the card differs from the CPU "
             f"by {res['tiny_rel_err']} of the largest (limit {PRE_TINY_REL})")
    log(f"phase 24 (a) SAM ViT-H encoder, 1024^2: {res['encoder_ms']:.3f} ms "
        f"median of 3 (TF32 on: {res['encoder_ms_tf32']:.3f}), peak "
        f"{res['peak_gib']:.3f} GiB, {res['params']:,} parameters; "
        f"VIT_TINY_TEST card vs CPU {res['tiny_rel_err']} of the largest "
        f"({smi})")
    return res, model


def sam_generator_check(model, dev, smi: str):
    """Phase 24 (b) and (c): the generator at 1080x1440 (32x32 points, 64
    a batch, thresholds open), decode ms a batch, generate s, masks a
    level before and after the box NMS; masks_update on its levels, and
    the intersection product on candidate masks (its counts against the
    int64 sum of logical_and on 64 random pairs)."""
    from langsplatv2_tpu_torch.preprocess import masks as pmasks
    from langsplatv2_tpu_torch.preprocess import sam

    gen = sam.TorchSamMaskGenerator(model, device=dev, **PRE_OPEN)
    img = synthetic_photo(0)
    with torch.no_grad():
        x, (nh, nw) = gen._preprocess(img)
        embed = model.encode_image(x)
        pts = torch.as_tensor(gen.points(nh, nw)[:gen.points_per_batch],
                              dtype=torch.float32, device=dev)[:, None]
        ones = torch.ones((pts.shape[0], 1), device=dev)
        decode_ms = statistics.median(
            cuda_ms(lambda: model.decode_masks(embed, pts, ones), 1)[0]
            for _ in range(3))
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    levels = gen.generate(img, stats)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    after = [len(lv) for lv in levels]
    for lv in levels:
        for m in lv:
            seg, (bx, by, bw, bh) = m["segmentation"], m["bbox"]
            if seg.shape != (PRE_H, PRE_W) or seg.dtype != bool or \
                    bx + bw > PRE_W or by + bh > PRE_H or \
                    not math.isfinite(m["predicted_iou"]):
                fail(f"phase 24 (b): a malformed mask {seg.shape} "
                     f"{m['bbox']} {m['predicted_iou']}")
    if not all(0 < a <= b for a, b in zip(after, stats["candidates"])):
        fail(f"phase 24 (b): masks a level {after} against candidates "
             f"{stats['candidates']}")
    res = dict(decode_ms_batch=decode_ms, generate_s=gen_s,
               candidates=stats["candidates"], after_box_nms=after,
               batches=math.ceil(len(gen.points(nh, nw))
                                 / gen.points_per_batch))
    log(f"phase 24 (b) generator, {PRE_H}x{PRE_W} ({len(gen.points(nh, nw))} "
        f"points, {gen.points_per_batch} a batch, thresholds open): decode "
        f"{decode_ms:.3f} ms a batch, generate {gen_s:.3f} s, masks a level "
        f"{stats['candidates']} -> {after} after the box NMS ({smi})")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    updated = pmasks.masks_update(*levels, device=dev)
    torch.cuda.synchronize()
    res["masks_update_s"] = time.perf_counter() - t0
    res["after_masks_update"] = [len(lv) for lv in updated]
    with torch.no_grad():
        per = gen._mask_data(img)
    cand = torch.stack([e["segmentation"]
                        for e in per[1][:PRE_GRAM_MASKS]])
    del per
    gram_ms, inter = cuda_ms(lambda: pmasks.intersection_counts(cand, dev),
                             3)
    rng = np.random.default_rng(0)
    bad = 0
    for i, j in rng.integers(0, len(cand), (64, 2)):
        ref = int(torch.logical_and(cand[i], cand[j]).sum(dtype=torch.int64))
        bad += int(inter[i, j]) != ref or float(inter[i, j]) != ref
    if bad:
        fail(f"phase 24 (c): {bad} of 64 intersection counts differ from "
             "the int64 sums")
    m = len(cand)
    flops = 2.0 * m * m * PRE_H * PRE_W
    res.update(gram_ms=gram_ms, gram_masks=m,
               gram_tflops=flops / gram_ms / 1e9)
    log(f"phase 24 (c) masks_update: {res['after_masks_update']} kept of "
        f"{after} in {res['masks_update_s']:.3f} s; the intersection "
        f"product of {m} candidate masks ({PRE_H}x{PRE_W}): {gram_ms:.3f} ms "
        f"({res['gram_tflops']:.1f} TFLOP/s, f32 without TF32), 64 random "
        f"pairs equal to the int64 sums ({smi})")
    return res, gen


def preprocess_pipeline_check(gen, dev, smi: str) -> dict:
    """Phase 24 (d): PreprocessPipeline on 3 images with the hash CLIP
    backend, read back by Camera.get_language_feature_compact."""
    import shutil

    from langsplatv2_tpu_torch.preprocess.pipeline import PreprocessPipeline

    out = PRE_ROOT / "pipeline"
    shutil.rmtree(out, ignore_errors=True)
    images = [synthetic_photo(s) for s in (1, 2, 3)]
    names = [f"view_{i}.png" for i in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    PreprocessPipeline(gen, "hash", dev).run(images, names, str(out))
    wall = time.perf_counter() - t0
    rows = []
    for i in range(3):
        cam = Camera(0, np.eye(3), np.zeros(3), 1.0, 0.8, None, f"view_{i}",
                     0, image_width=PRE_W, image_height=PRE_H)
        for lvl in range(4):
            table, seg = cam.get_language_feature_compact(str(out), lvl)
            norms = np.linalg.norm(table, axis=1)
            ids = np.unique(seg[seg >= 0])
            if seg.shape != (PRE_H, PRE_W) or not len(ids) or \
                    seg.max() >= len(table) or seg.min() < -1 or \
                    np.abs(norms - 1.0).max() > 1e-5:
                fail(f"phase 24 (d): view_{i} level {lvl}: seg "
                     f"{seg.shape} ids {ids[:5]}, table {table.shape}")
        rows.append(len(table))
    res = dict(wall_s=wall, s_per_image=wall / 3, feature_rows=rows)
    log(f"phase 24 (d) pipeline, 3 images at {PRE_H}x{PRE_W}, hash CLIP: "
        f"{wall / 3:.3f} s an image, {rows} feature rows, read back by "
        f"Camera.get_language_feature_compact at every level ({smi})")
    return res


def cluster_check(dev, smi: str) -> dict:
    """Phase 24 (e): the cluster segmenter at 1080x1440, twice, the same
    masks both times."""
    from langsplatv2_tpu_torch.preprocess.pipeline import ClusterMaskGenerator

    gen = ClusterMaskGenerator(device=dev)
    img = synthetic_photo(4)
    walls, runs = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(gen(img))
        walls.append(time.perf_counter() - t0)
    counts = [len(lv) for lv in runs[0]]
    if not all(counts):
        fail(f"phase 24 (e): an empty level {counts}")
    same = [len(a) == len(b) and all(
        np.array_equal(m["segmentation"], r["segmentation"])
        for m, r in zip(a, b)) for a, b in zip(*runs)]
    if not all(same):
        fail(f"phase 24 (e): two runs gave other masks (levels {same})")
    log(f"phase 24 (e) cluster segmenter, {PRE_H}x{PRE_W}: {walls[0]:.3f} / "
        f"{walls[1]:.3f} s an image, masks a level {counts}, equal in both "
        f"runs ({smi})")
    return dict(s_per_image=walls, masks=counts)


def preprocess_cli_check(dev, smi: str) -> dict:
    """Phase 24 (f): `preprocess.cli --mask_backend cluster` on 2 images,
    in process, its files byte-equal to the in-process pipeline's."""
    import io as pyio
    import shutil

    from PIL import Image

    from langsplatv2_tpu_torch.preprocess import cli
    from langsplatv2_tpu_torch.preprocess.pipeline import (
        ClusterMaskGenerator, PreprocessPipeline, load_images)

    scene = PRE_ROOT / "scene"
    shutil.rmtree(scene, ignore_errors=True)
    (scene / "images").mkdir(parents=True)
    for i in range(2):
        Image.fromarray(synthetic_photo(5 + i)).save(
            scene / "images" / f"frame_{i:05d}.png")
    captured = pyio.StringIO()
    stdout, sys.stdout = sys.stdout, captured
    t0 = time.perf_counter()
    try:
        summary = cli.main(["--dataset_path", str(scene), "--mask_backend",
                            "cluster", "--clip_backend", "hash"])
    finally:
        sys.stdout = stdout
    wall = time.perf_counter() - t0
    images, names = load_images(str(scene), device=dev)
    PreprocessPipeline(ClusterMaskGenerator(device=dev), "hash", dev).run(
        images, names, str(PRE_ROOT / "inproc"))
    for n in names:
        for suffix in ("_s.npy", "_f.npy"):
            base = os.path.splitext(n)[0] + suffix
            a = (scene / "language_features" / base).read_bytes()
            b = (PRE_ROOT / "inproc" / base).read_bytes()
            if a != b:
                fail(f"phase 24 (f): the CLI's {base} differs from the "
                     "in-process run's")
    log(f"phase 24 (f) preprocess.cli --mask_backend cluster: 2 images in "
        f"{wall:.3f} s, files equal to the in-process pipeline's "
        f"({summary['mask_backend']}, {summary['clip_backend']}; {smi})")
    return dict(wall_s=wall, summary=summary)


def preprocess_path(dev, smi: str) -> dict:
    """Phase 24: (a) to (f) above."""
    t0 = time.perf_counter()
    enc, model = sam_encoder_check(dev, smi)
    res = dict(encoder=enc)
    res["generator"], gen = sam_generator_check(model, dev, smi)
    torch.cuda.empty_cache()
    res["pipeline"] = preprocess_pipeline_check(gen, dev, smi)
    del gen, model
    torch.cuda.empty_cache()
    res["cluster"] = cluster_check(dev, smi)
    res["cli"] = preprocess_cli_check(dev, smi)
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t0
    log(f"phase 24: {res['phase_s']:.1f} s")
    return res


# ------------- phase 25: distribution (K2 and K4 on strips; no new kernel)

DIST_RANKS = 4
DIST_ROOT = Path("build") / "chip_smoke_dist"
DIST_WRAPPERS = {"K1": "k1.launches", "K2": blend.blend_tiles,
                 "K4": train.feature_grads}
DIST_FRAMES = 2
# The Gaussian-sharded frame against the single-card sort route (JAX's
# test_sharding.py tolerance), d(quick_weights) against QuickTrainBlend's
# (1e-4 of the largest: index_add_ atomics), the tile-sharded losses and
# gradients against the single-card XLA route (test_sharding.py: loss rtol
# 1e-5, gradients 5e-4 of the largest; images atol 1e-5, radii exact), K2
# and K4 on strips against their plain versions (phase 3's atol 3e-5; 1e-5
# of the largest).
DIST_ATOL, DIST_GRAD_REL = 2e-5, 1e-4
TILE_ATOL, TILE_LOSS_RTOL, TILE_GRAD_REL = 1e-5, 1e-5, 5e-4
STRIP_K2_ATOL, STRIP_K4_REL = 3e-5, 1e-5
DIST_MIN_EXCHANGED = 10_000
DIST_LAMBDA = 0.2                     # the geometry loss's lambda_dssim
NCCL = "nccl"                         # (f)'s backend


def strip_ranges(start, count, t0: int, n: int, n_grid: int, e: int):
    """Slots t0 .. t0 + n - 1 of a whole grid's tile ranges; the first
    slot past the grid gets the 64 entries after the strip's last real
    tile (as the Gaussian-sharded receiver's sentinel slot holds rows),
    later ones none. Returns (starts, counts, real slots)."""
    real = max(0, min(n, n_grid - t0))
    s = start[t0:t0 + real].clone()
    c = count[t0:t0 + real].clone()
    end = int(s[-1] + c[-1]) if real else int(start[t0])
    pad = n - real
    if pad:
        m = min(64, e - end)
        s = torch.cat([s, torch.full((pad,), end, dtype=torch.int32,
                                     device=s.device)])
        s[real + 1:] += m
        c = torch.cat([c, torch.zeros(pad, dtype=torch.int32,
                                      device=c.device)])
        c[real] = m
    return s.contiguous(), c.contiguous(), real


def strip_kernels(dev) -> dict:
    """Phase 25 (a): on a reduced scene (50k Gaussians, 512x512, 1,024
    tiles) K2 f32 quick (192 channels) and rgb and K4 (C = 64) on strips
    from tile_base > 0, one inside the grid and one past it, against their
    plain versions (K2 atol 3e-5 with its pair counts equal; K4 1e-5 of
    its largest row, the rows outside the strip's real tiles 0), and equal
    bit for bit to the same slots of the whole-grid launch."""
    model = from_numpy_params(bench_scene(50_000, seed=1), device=dev)
    h = w = 512
    view, pm, tfx, tfy = bench_camera(h, w)
    s = RasterizeSettings(h, w, tfx, tfy, 0, max_entries=1 << 20)
    x = stage_inputs(model, s, view, pm, (None, None), dev)
    gx, gy = s.grid_x, s.grid_y
    n_grid = gx * gy
    g, start, count, geom = x["g"], x["start"], x["count"], x["geom"]
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    modes = (("quick", (x["qw"], x["qi"], L * K)), ("rgb", ()))
    gen = torch.Generator(device=dev).manual_seed(25)
    cot = torch.randn(n_grid, 256, 64, device=dev, generator=gen)
    whole = {m: blend.blend_tiles(g, start, count, geom, bg, gx, gy, *q)
             for m, q in modes}
    whole_k4 = train.feature_grads(g, start, count, geom, cot, gx, gy)
    res = {}
    for label, t0, n in (("inside", 200, 300),
                         ("past_grid", n_grid - 200, 256)):
        st, ct, real = strip_ranges(start, count, t0, n, n_grid, g.shape[0])
        r = {}
        for m, q in modes:
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            out = blend.blend_tiles(g, st, ct, geom, bg, gx, gy, *q,
                                    stats=stats, tile_base=t0)
            ref = blend.blend_tiles_plain(g, st, ct, geom, bg, gx, *q,
                                          tile_base=t0, grid_tiles=n_grid)
            err = max_diff([(a, b) for a, b in zip(out, ref)
                            if a is not None])
            want = blend.pair_counts_plain(g, st, ct, geom, gx,
                                           tile_base=t0, grid_tiles=n_grid)
            same = all(torch.equal(a[:real], b[t0:t0 + real])
                       for a, b in zip(out, whole[m]) if a is not None)
            empty = real == n or bool((out[2][real:] == 1.0).all()
                                      and (out[0][real:] == bg).all())
            r[f"K2 {m}"] = dict(max_abs_err=err, pairs=want,
                                whole_grid_bit_equal=same,
                                past_grid_empty=empty)
            if not (err <= STRIP_K2_ATOL and same and empty
                    and (int(stats[0]), int(stats[1])) == want):
                fail(f"phase 25 (a) {label}: K2 {m} on a strip: "
                     f"{r[f'K2 {m}']}, counts {stats.tolist()}")
        cot_s = torch.cat([cot, torch.zeros(n, 256, 64, device=dev)])[
            t0:t0 + n].contiguous()
        d = train.feature_grads(g, st, ct, geom, cot_s, gx, gy, tile_base=t0)
        ref = train.feature_grads_plain(g, st, ct, geom, cot_s, gx, t0,
                                        n_grid)
        err = normalized_err(d, ref)
        lo, hi = int(st[0]), int(st[real - 1] + ct[real - 1])
        outside = max(float(d[:lo].abs().max()) if lo else 0.0,
                      float(d[hi:].abs().max()) if hi < d.shape[0] else 0.0)
        same = torch.equal(d[lo:hi], whole_k4[lo:hi])
        r["K4"] = dict(max_abs_err=err[0], rel_err=err[1],
                       outside_rows_max=outside, whole_grid_bit_equal=same)
        if not (err[1] <= STRIP_K4_REL and outside == 0.0 and same):
            fail(f"phase 25 (a) {label}: K4 on a strip: {r['K4']}")
        res[label] = dict(r, tile_base=t0, slots=n, real=real)
        log(f"phase 25 (a) {label} strip (tile_base {t0}, {n} slots, {real} "
            f"in the grid of {n_grid}): " + ", ".join(
                f"{k} {v['max_abs_err']:.3g}" for k, v in r.items()))
    return res


def pad_tiles(t, n: int):
    """t [T, ...] zero-padded to n rows."""
    if t.shape[0] >= n:
        return t
    return torch.cat([t, torch.zeros((n - t.shape[0],) + tuple(t.shape[1:]),
                                     dtype=t.dtype, device=t.device)])


def digest(*tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_rows(fields: dict, rank: int, world: int) -> dict:
    """The rank's rows of every per-Gaussian field."""
    n = fields["xyz"].shape[0]
    sl = slice(rank * (n // world), (rank + 1) * (n // world))
    return {k: (v[sl] if v.shape[0] == n else v) for k, v in fields.items()}


def model_inputs(model) -> dict:
    """rasterize's per-Gaussian inputs of a model (SH colour)."""
    return dict(scales=model.get_scaling(), rotations=model.get_rotation(),
                shs=model.get_features())


def k2_strip_row(ex, s, dev) -> dict:
    """K2 (f32 quick, 192 channels) on a rank's received strip at full
    width: held to its plain version (atol 3e-5, pair counts equal), timed
    beside it, with its bound for this strip's data (the live rows' id,
    state and pairs read once, the strip's tiles written)."""
    gx, gy = s.grid_x, s.grid_y
    g = torch.arange(ex.geom.shape[0], dtype=torch.int32, device=dev)
    bg = torch.zeros(3, device=dev)
    args = (g, ex.tile_start, ex.tile_count, ex.geom, bg, gx, gy, ex.qw,
            ex.qi, L * K)
    k2 = lambda: blend.blend_tiles(*args, tile_base=ex.tile_base)  # noqa: E731
    plain = lambda: blend.blend_tiles_plain(  # noqa: E731
        *args[:6], ex.qw, ex.qi, L * K, tile_base=ex.tile_base,
        grid_tiles=gx * gy)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    blend.blend_tiles(*args, stats=stats, tile_base=ex.tile_base)
    n_eval, n_inc = blend.pair_counts_plain(
        g, ex.tile_start, ex.tile_count, ex.geom, gx,
        tile_base=ex.tile_base, grid_tiles=gx * gy)
    ms, out = cuda_ms(k2, 10)
    plain_ms, ref = cuda_ms(plain, 1)
    err = max_diff(zip(out, ref))
    if not (err <= STRIP_K2_ATOL
            and (int(stats[0]), int(stats[1])) == (n_eval, n_inc)):
        fail(f"phase 25 (b): K2 on the received strip differs from its "
             f"plain version by {err} or in its counts {stats.tolist()} "
             f"against {(n_eval, n_inc)}")
    live = int(ex.tile_count.sum())
    strip = ex.tile_start.shape[0]
    b_ms, b_by = bound(live * (4 + 9 * 4 + L * TOPK * 8) + strip * 8
                       + strip * 256 * (3 + L * K + 1) * 4,
                       n_eval * BLEND_ALPHA_FLOPS + n_inc
                       * BLEND_INCLUDE_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, max_abs_err=err, pairs_evaluated=n_eval,
                pairs_included=n_inc, rows=live, slots=strip)


def k4_strip_row(ex, cot_s, s, dev) -> dict:
    """K4 (C = 64) on a rank's received strip at full width, held to its
    plain version (1e-5 of its largest row) and timed beside it, with its
    bound (phase 7's: the covered rows' ids and dF, the cotangent)."""
    gx, gy = s.grid_x, s.grid_y
    c = cot_s.shape[2]
    g = torch.arange(ex.geom.shape[0], dtype=torch.int32, device=dev)
    args = (g, ex.tile_start, ex.tile_count, ex.geom, cot_s)
    k4 = lambda: train.feature_grads(*args, gx, gy,  # noqa: E731
                                     tile_base=ex.tile_base)
    plain = lambda: train.feature_grads_plain(  # noqa: E731
        *args, gx, ex.tile_base, gx * gy)
    ms, out = cuda_ms(k4, 10)
    plain_ms, ref = cuda_ms(plain, 1)
    err = normalized_err(out, ref)
    if not err[1] <= STRIP_K4_REL:
        fail(f"phase 25 (c): K4 on the received strip differs from its "
             f"plain version by {err}")
    n_eval, n_inc = blend.pair_counts_plain(
        g, ex.tile_start, ex.tile_count, ex.geom, gx,
        tile_base=ex.tile_base, grid_tiles=gx * gy)
    covered = int(ex.tile_count.sum())
    strip = ex.tile_start.shape[0]
    b_ms, b_by = bound(covered * 4 + strip * 8 + covered * 24
                       + cot_s.numel() * 4 + covered * c * 4,
                       n_eval * BLEND_ALPHA_FLOPS + n_inc * (3 + 2 * c),
                       F32_TENSOR_FLOPS)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, max_abs_err=err[0], rel_err=err[1],
                rows=covered, slots=strip)


def gauss_frame_rank(rank: int, world: int, dev, max_entries: int,
                     timed: bool) -> dict:
    """Phase 25 (b), and (f) in a world of one: the 1080p frame of phase
    4's scene sharded over the world, each rank holding its rows, at a
    pair capacity that cannot drop (the local budget), counted and timed;
    its strip against the single-card sort route's tiles (f32 rows); then
    (timed) K2 on rank 0's received strip; then (several ranks) the frame
    at a capacity below the largest pair's load, its drops against the
    host recount from every rank's segment lengths."""
    from langsplatv2_tpu_torch.parallel import (make_gauss_mesh,
                                                rasterize_gauss_sharded)
    from langsplatv2_tpu_torch.parallel import gauss_sharded as gs
    from langsplatv2_tpu_torch.parallel.distributed import all_gather, \
        sync_hosts

    fields = bench_scene(1_000_000)
    shard = from_numpy_params(rank_rows(fields, rank, world), device=dev)
    _, h, w, _ = LOADS[0]
    view, pm, tfx, tfy = bench_camera(h, w)
    s = RasterizeSettings(h, w, tfx, tfy, 0, max_entries=max_entries,
                          assemble=False)
    gx, gy = s.grid_x, s.grid_y
    z = np.zeros(3, np.float32)
    mesh = make_gauss_mesh(device=dev)
    inputs = (shard.xyz, shard.get_opacity(), view, pm, z)
    kw = dict(model_inputs(shard), quick_weights=shard.quick_weights,
              quick_indices=shard.quick_indices)
    full_cap = gs.plan(s, world, None)["local_budget"]
    res = dict(default_cap=gs.plan(s, world, None)["cap"],
               full_cap=gs.plan(s, world, full_cap)["cap"])

    def frame(cap, st=None):
        return rasterize_gauss_sharded(mesh, s, *inputs, z, **kw,
                                       quick_channels=L * K,
                                       pair_capacity=cap, gather=False,
                                       stats=st)

    frame(full_cap)                      # warm-up
    stats, ms = {}, []
    sync_hosts()
    zero_counts(DIST_WRAPPERS)
    for _ in range(DIST_FRAMES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = frame(full_cap, stats)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    res["launches"] = read_counts(DIST_WRAPPERS)
    rgb_t, feat_t, t_t, total, dropped, radii = out
    t0, strip = stats["tile_base"], stats["strip"]
    res.update(frame_ms=ms, frame_ms_median=statistics.median(ms),
               total=int(total), dropped=int(dropped),
               local_budget=stats["local_budget"],
               local_total=int(stats["local_total"]),
               received=int(stats["received"]),
               dcount=stats["dcount"].tolist(), tile_base=t0, strip=strip,
               finite=all(bool(torch.isfinite(t).all())
                          for t in (rgb_t, feat_t, t_t)),
               digest=digest(rgb_t, feat_t, t_t))
    # The single-card sort route on the whole scene, f32 rows.
    full = from_numpy_params(fields, device=dev)
    ref = rasterize(s, full.xyz, full.get_opacity(), view, pm, z, z,
                    **model_inputs(full), quick_weights=full.quick_weights,
                    quick_indices=full.quick_indices, quick_channels=L * K,
                    device=dev)
    real = max(0, min(strip, gx * gy - t0))
    tiles = lambda img: pad_tiles(image_to_tiles(  # noqa: E731
        img, gx, gy), t0 + strip)[t0:t0 + real]
    inside = tiles(torch.ones((1, h, w), device=dev))
    ref_feat = ref.feature_map[t0:t0 + real]
    n_loc = full.xyz.shape[0] // world
    res["max_abs_err"] = max(
        float(((rgb_t[:real] - tiles(ref.rgb)) * inside).abs().max()),
        float((feat_t[:real] - ref_feat).abs().max()),
        float(((t_t[:real, :, None] - tiles(ref.final_transmittance[None]))
               * inside).abs().max()))
    res["feature_bit_equal_to_single_card"] = bool(
        torch.equal(feat_t[:real], ref_feat))
    res["radii_equal"] = bool(torch.equal(
        radii, ref.radii[rank * n_loc:(rank + 1) * n_loc]))
    res["single_card_total"] = int(ref.total_entries)
    if world == 1:     # the digests of each 4-rank strip of this frame
        s4 = -(-gx * gy // DIST_RANKS)
        parts = [pad_tiles(t, s4 * DIST_RANKS) for t in (rgb_t, feat_t, t_t)]
        res["strip_digests"] = [
            digest(*(p[r * s4:(r + 1) * s4] for p in parts))
            for r in range(DIST_RANKS)]
    del ref, full, ref_feat, inside, out, rgb_t, feat_t, t_t
    torch.cuda.empty_cache()
    if timed:
        ex, _ = gs.exchange(mesh, s, *inputs, **kw, pair_capacity=full_cap)
        if rank == 0:
            res["K2strip"] = k2_strip_row(ex, s, dev)
        del ex
        torch.cuda.empty_cache()
        sync_hosts()
    if world > 1:     # the capacity stepped below the largest pair's load
        loads = all_gather(stats["dcount"].reshape(1, -1).cpu(),
                           mesh.groups["gauss"])
        peak = int(loads.max())
        cap2 = max(128, (int(peak * 0.75) // 128) * 128)
        out2 = frame(cap2)
        res["starved"] = dict(
            cap=cap2, peak_pair_load=peak, dropped=int(out2[4]),
            recount=int(torch.clamp(loads - cap2, min=0).sum()),
            total=int(out2[3]),
            finite=all(bool(torch.isfinite(t).all()) for t in out2[:3]))
        del out2
    return res


def gauss_feature_rank(rank: int, world: int, dev) -> dict:
    """Phase 25 (c) on one rank: phase 7's scene (300k, 544x960, one level
    of 64 codes, top-4) sharded over the world; the strip's term of the
    loss sum(feat * cot) for a seeded cotangent, its backward through the
    reverse all-to-all, d(quick_weights) of the rank's rows against the
    single-card QuickTrainBlend gradient; then K4 on rank 0's strip."""
    from langsplatv2_tpu_torch.parallel import make_gauss_mesh
    from langsplatv2_tpu_torch.parallel import gauss_sharded as gs
    from langsplatv2_tpu_torch.parallel.distributed import sync_hosts

    model, _ = train_scene(TRAIN_N, 0, dev)
    with torch.no_grad():
        qw, qi = model.get_weights_and_indices(TRAIN_TOPK)
    cam = train_cameras("dist", TRAIN_YAW_DEG[:1], TRAIN_H, TRAIN_W)[0]
    s = make_settings(cam, 0, 1.0, 2 ** 21)._replace(assemble=False)
    gx, gy = s.grid_x, s.grid_y
    n_loc = TRAIN_N // world
    sl = slice(rank * n_loc, (rank + 1) * n_loc)
    gen = torch.Generator(device=dev).manual_seed(7)
    cot = torch.randn(gx * gy, 256, TRAIN_K, device=dev, generator=gen)
    mesh = make_gauss_mesh(device=dev)
    z = np.zeros(3, np.float32)
    view, pm, cpos = (cam.world_view_transform, cam.full_proj_transform,
                      cam.camera_center)
    shard_in = dict(scales=model.get_scaling()[sl],
                    rotations=model.get_rotation()[sl],
                    shs=model.get_features()[sl])
    q = qw[sl].detach().clone().requires_grad_(True)
    stats = {}
    sync_hosts()
    zero_counts(DIST_WRAPPERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _rgb, feat_t, _t, total, dropped = \
        gs.rasterize_gauss_sharded_feature_train(
            mesh, s, model.xyz[sl], model.get_opacity()[sl], view, pm, cpos,
            z, q, qi[sl], TRAIN_K, **shard_in, stats=stats)
    base, strip = stats["tile_base"], stats["strip"]
    cot_s = pad_tiles(cot, base + strip)[base:base + strip].contiguous()
    (feat_t * cot_s).sum().backward()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counts(DIST_WRAPPERS)
    q_ref = qw.detach().clone().requires_grad_(True)
    out = rasterize(s, model.xyz, model.get_opacity(), view, pm, cpos, z,
                    **model_inputs(model), quick_weights=q_ref,
                    quick_indices=qi, quick_channels=TRAIN_K,
                    quick_train=True, device=dev)
    (out.feature_map * cot).sum().backward()
    err = normalized_err(q.grad, q_ref.grad[sl])
    res = dict(step_ms=step_ms, launches=launches, total=int(total),
               dropped=int(dropped), local_total=int(stats["local_total"]),
               local_budget=stats["local_budget"],
               max_abs_err=err[0], rel_err=err[1],
               grad_max=float(q.grad.abs().max()),
               single_card_total=int(out.total_entries))
    del out, q_ref
    torch.cuda.empty_cache()
    ex, _ = gs.exchange(mesh, s, model.xyz[sl], model.get_opacity()[sl],
                        view, pm, cpos, **shard_in, quick_weights=qw[sl],
                        quick_indices=qi[sl])
    if rank == 0:
        res["K4strip"] = k4_strip_row(ex, cot_s, s, dev)
    del ex
    sync_hosts()
    return res


def tile_cameras(n: int = 2):
    """The first n of phase 7's cameras as (views, projs, camposs)."""
    cams = train_cameras("dist", TRAIN_YAW_DEG[:n], TRAIN_H, TRAIN_W)
    return tuple(np.stack([getattr(c, a) for c in cams]) for a in (
        "world_view_transform", "full_proj_transform", "camera_center"))


def tile_gt(n: int = 2) -> tuple:
    """A seeded 512 x 512 segment table and n segment maps of 48-pixel
    blocks with ~5% of pixels at -1 (write_gt's), and n U(0, 1) images."""
    rng = np.random.default_rng(25)
    table = rng.normal(size=(TRAIN_S, 512)).astype(np.float32)
    segs, images = [], []
    for _ in range(n):
        ids = rng.integers(0, TRAIN_S, (-(-TRAIN_H // 48), -(-TRAIN_W // 48)))
        seg = np.repeat(np.repeat(ids, 48, 0), 48, 1)[:TRAIN_H, :TRAIN_W]
        seg = seg.astype(np.int32)
        seg[rng.uniform(size=(TRAIN_H, TRAIN_W)) < 0.05] = -1
        segs.append(seg)
        images.append(rng.uniform(0, 1, (3, TRAIN_H, TRAIN_W)).astype(
            np.float32))
    return np.stack([table] * n), np.stack(segs), np.stack(images)


def tile_settings():
    cam = train_cameras("dist", TRAIN_YAW_DEG[:1], TRAIN_H, TRAIN_W)[0]
    return make_settings(cam, 3, 1.0, XLA_MAX_ENTRIES, XLA_TILE_CAP, 16,
                         impl="xla")


def tile_models(dev):
    """(d)'s scenes: phase 23's geometry scene (300k, SH 3) and phase 7's
    feature scene (300k, one level of 64 codes)."""
    rgb_model, _ = rgb_scene(RGB_N, TRAIN_H, TRAIN_W, 0, 0, dev)
    feat_model, _ = train_scene(TRAIN_N, 0, dev)
    return rgb_model, feat_model


def tile_references(dev) -> tuple[dict, dict]:
    """Phase 25 (d)'s single-card references on the XLA route: the frame
    of camera 0 (rgb, final T, radii), the camera mean of the Gram loss
    (logits' and codebooks' gradients) and of the geometry loss (the six
    fields', the means2D carrier's, radii), for the ranks; and the
    geometry model's fields as built (what (e)'s checkpoint holds)."""
    s = tile_settings()
    rgb_model, feat_model = tile_models(dev)
    fields = {k: v.detach().cpu().numpy()
              for k, v in rgb_model.fields().items() if v is not None}
    views, projs, camposs = tile_cameras()
    tables, segs, images = tile_gt()
    z = np.zeros(3, np.float32)
    ref = {}
    out = render(s, rgb_model, views[0], projs[0], camposs[0], z, device=dev)
    ref["frame"] = dict(rgb=out.render, t=out.final_transmittance,
                        radii=out.radii)
    params = trainer.feature_params(feat_model)
    loss = 0.0
    for b in range(len(views)):
        out = render(s._replace(sh_degree=0), feat_model, views[b],
                     projs[b], camposs[b], z, include_feature=True,
                     topk=TRAIN_TOPK, device=dev)
        loss = loss + trainer.gram_cos_loss(
            feat_model.codebooks, out.language_feature_weight_map,
            torch.as_tensor(tables[b], device=dev),
            torch.as_tensor(segs[b], device=dev), 0) / len(views)
    loss.backward()
    ref["gram"] = dict(loss=float(loss.detach()),
                       grads={k: p.grad.detach().clone()
                                                for k, p in params.items()})
    params = trainer.rgb_params(rgb_model)
    dummy = torch.zeros((rgb_model.capacity, 2), device=dev,
                        requires_grad=True)
    loss = l1s = 0.0
    radii = []
    for b in range(len(views)):
        out = render(s, rgb_model, views[b], projs[b], camposs[b], z,
                     means2d_dummy=dummy, device=dev)
        gt = torch.as_tensor(images[b], device=dev)
        l1 = losses.l1_loss(out.render, gt)
        loss = loss + ((1 - DIST_LAMBDA) * l1 + DIST_LAMBDA * (
            1.0 - losses.ssim(out.render, gt))) / len(views)
        l1s = l1s + float(l1.detach()) / len(views)
        radii.append(out.radii)
    loss.backward()
    ref["rgb"] = dict(loss=float(loss.detach()), l1=l1s,
                      radii=torch.stack(radii),
                      dummy=dummy.grad.detach().clone(),
                      grads={k: p.grad.detach().clone()
                             for k, p in params.items()})
    return ref, fields


def grad_errs(got: dict, want: dict) -> dict:
    """Each gradient's max |got - want| over want's largest."""
    return {k: normalized_err(got[k], w)[1] for k, w in want.items()
            if w.numel()}


def tile_sharded_rank(rank: int, world: int, dev, cfg: dict) -> dict:
    """Phase 25 (d) and (e) on one rank: rasterize_sharded on (1, 4); on
    (2, 2) the Gram loss and its gradients, a Gram feature step, the
    geometry loss, its gradients and the carrier's, and a geometry step
    with the batch's densification statistics, against the saved
    single-card references; then the multi-process checkpoint."""
    from langsplatv2_tpu_torch.parallel import (
        make_device_mesh, make_sharded_feature_train_step,
        make_sharded_rgb_train_step, rasterize_sharded,
        save_checkpoint_multihost, sync_hosts)
    from langsplatv2_tpu_torch.parallel import sharding as sh

    ref = torch.load(cfg["tile_ref"], map_location=dev)
    s = tile_settings()
    rgb_model, feat_model = tile_models(dev)
    views, projs, camposs = tile_cameras()
    tables, segs, images = tile_gt()
    z = np.zeros(3, np.float32)
    res, ms = {}, {}

    def timed(name, fn):
        sync_hosts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    mesh14 = make_device_mesh(1, 4, device=dev)
    mesh22 = make_device_mesh(2, 2, device=dev)
    rgb, _, radii, final_t = timed("rasterize_sharded_1x4", lambda: (
        rasterize_sharded(mesh14, s, rgb_model.xyz, rgb_model.get_opacity(),
                          views[0], projs[0], camposs[0], z,
                          **model_inputs(rgb_model))))
    res["frame"] = dict(
        max_abs_err=max_diff([(rgb, ref["frame"]["rgb"]),
                              (final_t, ref["frame"]["t"])]),
        radii_equal=bool(torch.equal(radii, ref["frame"]["radii"])))
    del rgb, final_t
    d = mesh22.coords["data"]
    cams = (views[d:d + 1], projs[d:d + 1], camposs[d:d + 1])

    params = trainer.feature_params(feat_model)
    build = sh.make_sharded_gram_loss(mesh22, s._replace(sh_degree=0),
                                      TRAIN_TOPK)
    partial, loss = timed("gram_loss_and_backward", lambda: build(
        feat_model, *cams, z, tables[d:d + 1], segs[d:d + 1]))
    partial.backward()
    sh.reduce_gradients(params.values(), mesh22)
    res["gram"] = dict(loss=float(loss), ref_loss=ref["gram"]["loss"],
                       grad_rel=grad_errs({k: p.grad for k, p in
                                           params.items()},
                                          ref["gram"]["grads"]))
    opt = trainer.make_feature_optimizer(
        OptimizationParams(argparse.ArgumentParser()), feat_model)
    step = make_sharded_feature_train_step(mesh22, s._replace(sh_degree=0),
                                           opt, TRAIN_TOPK)
    logits0 = feat_model.language_logits.detach().clone()
    met = timed("gram_step", lambda: step(feat_model, *cams, z,
                                          tables[d:d + 1], segs[d:d + 1]))
    res["gram"].update(step_loss=float(met["loss"]), logits_moved=float(
        (feat_model.language_logits.detach() - logits0).abs().max()))
    del feat_model, params, opt, step, partial
    torch.cuda.empty_cache()

    params = trainer.rgb_params(rgb_model)
    dummy = torch.zeros((rgb_model.capacity, 2), device=dev,
                        requires_grad=True)
    build = sh.make_sharded_rgb_loss(mesh22, s, DIST_LAMBDA)
    partial, loss, l1, radii = timed("rgb_loss", lambda: build(
        rgb_model, dummy, *cams, z, images[d:d + 1]))
    timed("rgb_backward", partial.backward)
    sh.reduce_gradients([*params.values(), dummy], mesh22)
    res["rgb"] = dict(
        loss=float(loss), ref_loss=ref["rgb"]["loss"], l1=float(l1),
        ref_l1=ref["rgb"]["l1"],
        radii_equal=bool(torch.equal(radii[0], ref["rgb"]["radii"][d])),
        grad_rel=grad_errs({k: p.grad for k, p in params.items()},
                           ref["rgb"]["grads"]),
        carrier_rel=normalized_err(dummy.grad, ref["rgb"]["dummy"])[1])
    del partial, dummy, params
    torch.cuda.empty_cache()
    # The model is as built (the loss changed no parameter): checkpointed
    # first (e), then stepped.
    save_checkpoint_multihost(cfg["ckpt"], rgb_model, None, 25,
                              extra={"rank": rank})
    opt = trainer.make_rgb_optimizer(
        OptimizationParams(argparse.ArgumentParser()), rgb_model)
    step = make_sharded_rgb_train_step(mesh22, s, opt, DIST_LAMBDA)
    xyz0 = rgb_model.xyz.detach().clone()
    met = timed("rgb_step", lambda: step(rgb_model, *cams, z,
                                         images[d:d + 1]))
    res["rgb"].update(
        step_loss=float(met["loss"]), num_visible=int(met["num_visible"]),
        xyz_moved=float((rgb_model.xyz.detach() - xyz0).abs().max()),
        accum_max=float(rgb_model.xyz_gradient_accum.max()),
        denom_max=float(rgb_model.denom.max()),
        max_radii2d_max=float(rgb_model.max_radii2d.max()))
    res["ms"] = ms
    return res


def rank_device(cfg: dict):
    """The ranks' device (cfg "device", cuda:0: they share the card)."""
    dev = torch.device(cfg["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    return dev


def dist_rank(rank: int, world: int, cfg: dict) -> dict:
    """A rank of phase 25's gloo world: four ranks share cuda:0."""
    dev = rank_device(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = dict(frame=gauss_frame_rank(rank, world, dev, cfg["max_entries"],
                                      True))
    torch.cuda.empty_cache()
    res["feature"] = gauss_feature_rank(rank, world, dev)
    torch.cuda.empty_cache()
    res["tile"] = tile_sharded_rank(rank, world, dev, cfg)
    return res


def nccl_rank(rank: int, world: int, cfg: dict) -> dict:
    """Phase 25 (f): (b)'s frame in a world of one rank over NCCL."""
    dev = rank_device(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    res = gauss_frame_rank(rank, world, dev, cfg["max_entries"], False)
    res["backend"] = dist.get_backend()
    return res


def fresh_dir(name: str) -> Path:
    """An empty directory under DIST_ROOT (a file store must be new)."""
    import shutil
    d = DIST_ROOT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def check_tile_rank(r: dict, label: str) -> None:
    """(d)'s tolerances on one rank's results."""
    f, g, rg = r["frame"], r["gram"], r["rgb"]
    bad = []
    if not (f["max_abs_err"] <= TILE_ATOL and f["radii_equal"]):
        bad.append(f"frame {f}")
    for name, v in (("gram", g), ("rgb", rg)):
        if not (math.isclose(v["loss"], v["ref_loss"], rel_tol=TILE_LOSS_RTOL)
                and math.isclose(v["step_loss"], v["ref_loss"],
                                 rel_tol=TILE_LOSS_RTOL)
                and max(v["grad_rel"].values()) <= TILE_GRAD_REL):
            bad.append(f"{name} loss {v['loss']!r} / {v['step_loss']!r} "
                       f"against {v['ref_loss']!r}, gradients "
                       f"{v['grad_rel']}")
    if not (math.isclose(rg["l1"], rg["ref_l1"], rel_tol=TILE_LOSS_RTOL)
            and rg["radii_equal"] and rg["carrier_rel"] <= TILE_GRAD_REL
            and rg["xyz_moved"] > 0 and rg["accum_max"] > 0
            and rg["denom_max"] >= 1.0 and g["logits_moved"] > 0):
        bad.append(f"rgb {rg}, gram logits moved {g['logits_moved']}")
    if bad:
        fail(f"phase 25 (d) {label}: " + "; ".join(bad))


def max_rel(tiles: list, loss: str) -> float:
    """The largest relative gradient error of `loss` over the ranks."""
    return max(max(t[loss]["grad_rel"].values()) for t in tiles)


def distribution_path(dev, smi: str) -> dict:
    """Phase 25: (a) to (f) above."""
    from langsplatv2_tpu_torch.parallel import spawn_ranks

    t_phase = time.perf_counter()
    res = dict(strips=strip_kernels(dev))
    torch.cuda.empty_cache()
    DIST_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ref_path = DIST_ROOT / "tile_ref.pt"
    ref, expect = tile_references(dev)
    torch.save(ref, ref_path)
    del ref
    ckpt = DIST_ROOT / "ckpt" / "chkpnt25.npz"
    ckpt.unlink(missing_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    res["references_s"] = time.perf_counter() - t0
    cfg = dict(max_entries=LOADS[0][3], tile_ref=str(ref_path),
               ckpt=str(ckpt), device=str(dev))

    t0 = time.perf_counter()
    ranks = spawn_ranks(dist_rank, DIST_RANKS, (cfg,),
                        store_dir=fresh_dir("gloo"), backend="gloo",
                        timeout=900)
    res["gloo_world_s"] = time.perf_counter() - t0
    res["ranks"] = ranks
    frames = [r["frame"] for r in ranks]
    f0 = frames[0]
    exchanged = sum(f["received"] for f in frames)
    launches = {k: sum(f["launches"][k] for f in frames)
                for k in DIST_WRAPPERS}
    checks = {
        "dropped == 0": all(f["dropped"] == 0 for f in frames),
        "totals agree": len({f["total"] for f in frames}) == 1
        and f0["total"] == sum(f["local_total"] for f in frames)
        == f0["single_card_total"],
        "no rank's K1 budget saturates": all(
            f["local_total"] < f["local_budget"] for f in frames),
        f"exchanged >= {DIST_MIN_EXCHANGED}": exchanged >= DIST_MIN_EXCHANGED,
        "strips within atol": max(f["max_abs_err"] for f in frames)
        <= DIST_ATOL,
        "radii equal": all(f["radii_equal"] for f in frames),
        "finite": all(f["finite"] for f in frames),
        "K1, K2 launched": launches["K1"] > 0 and launches["K2"] > 0,
    }
    starved = [f["starved"] for f in frames]
    checks["starved: dropped > 0 == recount"] = all(
        v["dropped"] == v["recount"] == starved[0]["recount"] > 0
        and v["total"] == f0["total"] and v["finite"] for v in starved)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        brief = [{k: v for k, v in f.items() if k != "dcount"}
                 for f in frames]
        fail(f"phase 25 (b): checks failed: {bad}; frames {brief}")
    peak = max(max(f["dcount"]) for f in frames)
    res["frame"] = dict(
        frame_ms_median=f0["frame_ms_median"], exchanged=exchanged,
        total=f0["total"], launches=launches, peak_pair_load=peak,
        default_cap=f0["default_cap"], full_cap=f0["full_cap"],
        default_cap_drops=sum(max(c - f0["default_cap"], 0)
                              for f in frames for c in f["dcount"]),
        max_abs_err=max(f["max_abs_err"] for f in frames),
        feature_bit_equal=all(f["feature_bit_equal_to_single_card"]
                              for f in frames),
        starved=starved[0])
    log(f"phase 25 (b) Gaussian-sharded 1080p frame, {DIST_RANKS} gloo "
        f"ranks on one card (host-staged exchange): median "
        f"{f0['frame_ms_median']:.1f} ms on rank 0 over {DIST_FRAMES}; "
        f"{exchanged} entries exchanged, total {f0['total']}, pair loads "
        f"up to {peak} (default capacity {f0['default_cap']}, run at "
        f"{f0['full_cap']}), max |strip - single card| "
        f"{res['frame']['max_abs_err']:.3g} (feature map bit-equal "
        f"{res['frame']['feature_bit_equal']}); capacity "
        f"{starved[0]['cap']}: dropped {starved[0]['dropped']} = recount; "
        f"launches {launches} ({smi})")

    feats = [r["feature"] for r in ranks]
    fl = {k: sum(f["launches"][k] for f in feats) for k in DIST_WRAPPERS}
    res["feature"] = dict(step_ms=feats[0]["step_ms"], launches=fl,
                          rel_err=max(f["rel_err"] for f in feats),
                          grad_max=max(f["grad_max"] for f in feats))
    if not (res["feature"]["rel_err"] <= DIST_GRAD_REL
            and res["feature"]["grad_max"] > 0
            and all(f["dropped"] == 0 and f["local_total"]
                    < f["local_budget"] for f in feats)
            and all(v > 0 for v in fl.values())
            and feats[0]["total"] == feats[0]["single_card_total"]):
        fail(f"phase 25 (c): {feats}")
    log(f"phase 25 (c) Gaussian-sharded feature step ({TRAIN_N} Gaussians, "
        f"{TRAIN_W}x{TRAIN_H}, K = {TRAIN_K}, top-{TRAIN_TOPK}): "
        f"d(quick_weights) within {res['feature']['rel_err']:.3g} of the "
        f"largest of QuickTrainBlend's; forward and backward "
        f"{feats[0]['step_ms']:.1f} ms on rank 0 (host-staged); launches "
        f"{fl} ({smi})")

    tiles = [r["tile"] for r in ranks]
    for i, t in enumerate(tiles):
        check_tile_rank(t, f"rank {i}")
    res["tile"] = dict(ms=tiles[0]["ms"], gram=tiles[0]["gram"],
                       rgb=tiles[0]["rgb"], frame=tiles[0]["frame"])
    log(f"phase 25 (d) tile-sharded at {TRAIN_W}x{TRAIN_H}, tile_cap "
        f"{XLA_TILE_CAP}: rasterize_sharded (1, 4) within "
        f"{tiles[0]['frame']['max_abs_err']:.3g}; on (2, 2) Gram loss "
        f"{tiles[0]['gram']['loss']!r} (single card "
        f"{tiles[0]['gram']['ref_loss']!r}), geometry loss "
        f"{tiles[0]['rgb']['loss']!r} ({tiles[0]['rgb']['ref_loss']!r}), "
        f"gradients within {max_rel(tiles, 'gram'):.3g} / "
        f"{max_rel(tiles, 'rgb'):.3g} "
        f"of the largest; rank 0 ms (host-staged) {tiles[0]['ms']} ({smi})")

    from langsplatv2_tpu_torch.models import io as port_io
    model, it = port_io.load_checkpoint(str(ckpt), device=dev)
    with np.load(ckpt) as data:
        manifest = json.loads(str(data["manifest"]))
    same = it == 25 and manifest["extra"] == {"rank": 0} and all(
        np.array_equal(getattr(model, k).detach().cpu().numpy(), v)
        for k, v in expect.items())
    res["checkpoint"] = dict(path=str(ckpt), equal=same,
                             extra=manifest["extra"])
    if not same:
        fail(f"phase 25 (e): the multi-process checkpoint {ckpt} does not "
             f"load equal to the model: {res['checkpoint']}")
    log(f"phase 25 (e) checkpoint written by rank 0 alone "
        f"({manifest['extra']}), read back on one card equal to the model")
    del model

    t0 = time.perf_counter()
    nccl = spawn_ranks(nccl_rank, 1, (cfg,), store_dir=fresh_dir("nccl"),
                       backend=NCCL, timeout=600)[0]
    res["nccl_world_s"] = time.perf_counter() - t0
    equal = nccl["strip_digests"] == [f["digest"] for f in frames]
    res["nccl"] = dict(backend=nccl["backend"], equal_to_gloo=equal,
                       max_abs_err=nccl["max_abs_err"],
                       frame_ms_median=nccl["frame_ms_median"],
                       dropped=nccl["dropped"], total=nccl["total"])
    if not (nccl["backend"] == NCCL and equal and nccl["dropped"] == 0
            and nccl["max_abs_err"] <= DIST_ATOL
            and nccl["total"] == f0["total"]):
        fail(f"phase 25 (f): the NCCL world's frame {res['nccl']}")
    log(f"phase 25 (f) NCCL world of one rank: the frame bit-equal to the "
        f"gloo ranks' strips, median {nccl['frame_ms_median']:.1f} ms "
        f"({smi})")
    res["kernel_rows"] = {
        "K2strip": dict(ranks[0]["frame"]["K2strip"], launches=launches["K2"],
                        max_abs_err=max(
                            ranks[0]["frame"]["K2strip"]["max_abs_err"],
                            *(v[f"K2 {m}"]["max_abs_err"]
                              for v in res["strips"].values()
                              for m in ("quick", "rgb")))),
        "K4strip": dict(ranks[0]["feature"]["K4strip"], launches=fl["K4"],
                        max_abs_err=max(
                            ranks[0]["feature"]["K4strip"]["max_abs_err"],
                            *(v["K4"]["max_abs_err"]
                              for v in res["strips"].values())))}
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 25: {res['phase_s']:.1f} s (references "
        f"{res['references_s']:.1f}, gloo world {res['gloo_world_s']:.1f}, "
        f"NCCL world {res['nccl_world_s']:.1f})")
    return res


def phase20_kernel_rows(p20s, p20t) -> dict:
    """The kernels line's rows of phase 20: K3, bf16 K3 and K2q at PQ = 17
    (1080p), K6a and K6b at K = 32 (a feature step)."""
    rows = {f"{k}pq17": dict(p20s[k], launches=p20s["launches"][k])
            for k in ("K3", "K3bf16", "K2q")}
    for k in ("K6a", "K6b"):
        rows[f"{k}K32"] = dict(p20t["step"][k], launches=p20t["launches"][k])
    return rows


def new_kernel_rows(lmc, probe_res) -> dict:
    """The kernels line's rows of phases 17 and 18 (K1 with_alpha timed at
    1080p; K9 f32 and bf16)."""
    r = lmc["loads"]["1080p"]["K1_with_alpha"]
    rows = {"K1_with_alpha": dict(
        r, launches=lmc["launches"]["K1_with_alpha"],
        max_abs_err=max(v["K1_with_alpha"]["max_abs_err"]
                        for v in lmc["loads"].values()))}
    for d in ("f32", "bf16"):
        rows[f"K9{d}"] = dict(probe_res[d], launches=probe_res["launches"])
    return rows


# The preprocess kernel's bytes a Gaussian at SH degree d: the mean,
# scales, rotation and opacity read (44 B), (d + 1)^2 SH rows of 12 B, and
# xy, depth, conic, radius, rgb, rect and tiles written (60 B); its f32
# operations a Gaussian (projection, covariance, conic, extents, rect:
# ~170) and ~9 an SH coefficient and channel.
PRE_READ, PRE_WRITE, PRE_FLOPS, PRE_SH_FLOPS = 44, 60, 170, 9


def preprocess_kernel_path(dev) -> dict:
    """Phase 26: the preprocess kernel (csrc/preprocess.cu) on phase 4's
    1M-Gaussian scene with seeded SH degree 3 rows, at 1080p with the
    opacity-aware extents: every field bit for bit against the plain
    version, both timed (and the torch.cat of the SH rows the kernel no
    longer needs), its bound, registers, spills and occupancy; the host
    time of a call; a served frame's launches (one kernel launch, no plain
    call); the frame under torch.cuda.set_sync_debug_mode("error"), and
    whether the plain path's camera copy (torch.as_tensor of the numpy
    matrices, as the parent did) is a synchronising operation."""
    f = bench_scene(1_000_000)
    rng = np.random.default_rng(26)
    f["features_rest"] = (0.1 * rng.normal(size=(1_000_000, 15, 3))
                          ).astype(np.float32)
    model = from_numpy_params(f, device=dev)
    if model.active_sh_degree != 3:
        fail(f"phase 26: SH degree {model.active_sh_degree}, expected 3")
    h, w = 1080, 1920
    view, pm, tfx, tfy = bench_camera(h, w)
    campos = np.float32([0.05, -0.02, 0.01])
    op = model.get_opacity()[:, 0].contiguous()
    scales, rots = model.get_scaling(), model.get_rotation()
    pair = (model.features_dc, model.features_rest)
    args = (model.xyz, scales, rots, pair, None, view, pm, campos, tfx, tfy,
            w, h, 3, 1.0)
    kern = lambda: projection.preprocess(*args, opacities=op)  # noqa: E731
    plain = lambda: projection.preprocess_plain(  # noqa: E731
        *args, opacities=op)
    # Events around back-to-back calls time the host here (a call's host
    # work outlasts the kernel): the device times come from the profiler.
    event_ms, out = cuda_ms(kern, 50)
    event_plain_ms, ref = cuda_ms(plain, 5)
    k_split = device_split(lambda: [kern() for _ in range(10)])
    p_split = device_split(plain)
    ms, plain_ms = k_split["device_total"] / 1e4, p_split["device_total"] / 1e3
    mism = {}
    for name in ref._fields:
        a, b = getattr(out, name), getattr(ref, name)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        mism[name] = int((a != b).sum())
    if any(mism.values()):
        fail(f"phase 26: the preprocess kernel differs from its plain "
             f"version: {mism}")
    cat_ms, _ = cuda_ms(lambda: torch.cat(pair, dim=1), 20)
    n = model.xyz.shape[0]
    coeffs = 16
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=None, max_abs_err=0.0,
               mismatches=mism, cat_ms=cat_ms, event_ms=event_ms,
               event_plain_ms=event_plain_ms,
               device_ops_kernel=k_split["launches"] / 10,
               device_ops_plain=p_split["launches"],
               host_ms_kernel=host_ms(kern, 20), host_ms_plain=host_ms(plain,
                                                                       5),
               visible=int((out.radius > 0).sum()))
    row["bound_ms"], row["bound_by"] = bound(
        n * (PRE_READ + 12 * coeffs + PRE_WRITE),
        n * (PRE_FLOPS + PRE_SH_FLOPS * 3 * coeffs))
    occ = kernels.occupancy("lsv2_preprocess_occupancy", 3)
    rep = [r for r in kernels.ptxas_report("preprocess.cu")]
    if any(r.get("spill_stores", 0) or r.get("spill_loads", 0) for r in rep):
        fail(f"phase 26: a preprocess instantiation spills: {rep}")
    row.update(occupancy=occ, ptxas=rep)
    log(f"preprocess kernel: {ms:.4f} ms (bound {row['bound_ms']:.4f}, "
        f"{row['bound_by']}), plain {plain_ms:.3f} ms "
        f"({row['device_ops_plain']} device operations), cat "
        f"{cat_ms:.4f} ms; events {event_ms:.4f} / {event_plain_ms:.3f} ms; "
        f"host {row['host_ms_kernel']:.3f} / {row['host_ms_plain']:.3f} ms "
        f"a call; {occ['blocks_per_sm']} blocks = {occ['warps_per_sm']} "
        f"warps an SM, {occ['registers']} registers, {occ['smem_bytes']} "
        "shared bytes")
    del out, ref

    # A served frame (the quick pairs of phase 4's scene): its launches.
    s = RasterizeSettings(h, w, tfx, tfy, 3, max_entries=SCENE_MAX_ENTRIES,
                          assemble=False)
    frame_args = (s, model, view, pm, campos, torch.zeros(3, device=dev))
    counted = {"launches": "preprocess.launches",
               "plain_calls": "preprocess.plain_calls"}
    with torch.no_grad():
        render(*frame_args, quick_render=True, device=dev)
        zero_counts(counted)
        for _ in range(4):
            render(*frame_args, quick_render=True, device=dev)
        row["frame_counts_4"] = read_counts(counted)
        if row["frame_counts_4"] != {"launches": 4, "plain_calls": 0}:
            fail(f"phase 26: a served frame's preprocess counts "
                 f"{row['frame_counts_4']} over 4 frames")
        torch.cuda.synchronize()
        sync = {}
        for label, fn in (
                ("served frame", lambda: render(*frame_args,
                                                quick_render=True,
                                                device=dev)),
                ("kernel, numpy camera", kern),
                ("pageable camera copy", lambda: torch.as_tensor(
                    view, dtype=torch.float32, device=dev))):
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
                sync[label] = "no synchronising operation"
            except RuntimeError as e:
                sync[label] = f"raised: {str(e).splitlines()[0]}"
            finally:
                torch.cuda.set_sync_debug_mode("default")
        row["sync_debug"] = sync
        log(f"preprocess sync debug: {sync}")
    if sync["kernel, numpy camera"] != "no synchronising operation":
        fail(f"phase 26: the kernel path synchronised: {sync}")
    del model
    torch.cuda.empty_cache()
    return row


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float32 steps between two tensors of values
    >= 0 (NaN pairs count 0)."""
    d = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    return int(torch.where(torch.isnan(a) & torch.isnan(b), 0, d).max())


def topk_codes_path(dev) -> dict:
    """Phase 27: the top-k codes kernel (csrc/topk_codes.cu) at the feature
    cell's shape, [1M, 64] logits, top 4: indices bit for bit and weights
    in float32 steps against the plain path; the backward against autograd
    through the plain path (1e-6 of the largest, exactly 0 outside the
    selected columns); the device ms of each (the profiler's device time)
    beside the kernel's byte bounds (and portbench/roofline.py's), the
    plain path's and the library calls' (torch.topk, sort, gather,
    softmax); registers, spills (a spill fails) and occupancy; one launch
    forward and one backward a step, and no stream synchronisation on the
    kernel path. The row's max_abs_err is the larger of the weights' and
    d(logits)' largest differences."""
    from portbench import roofline

    n, k_all, topk = 1_000_000, 64, TRAIN_TOPK
    gen = torch.Generator(dev).manual_seed(27)
    x = torch.randn(n, k_all, device=dev, generator=gen)
    g = torch.randn(n, topk, device=dev, generator=gen)
    kern = lambda: topk_codes.topk_codes_kernel(x, topk)  # noqa: E731
    plain = lambda: sparse_codes.get_weights_and_indices_plain(  # noqa: E731
        x, topk)

    def library():
        _, i = torch.topk(x, topk, dim=1)
        i, _ = torch.sort(i, dim=1)
        return torch.softmax(torch.gather(x, 1, i), dim=1), i

    w, idx = kern()
    ref_w, ref_i = plain()
    idx_mism = int((idx != ref_i).sum())
    w_ulps = _ulps(w, ref_w)
    if idx_mism or w_ulps > 2:
        fail(f"phase 27: the top-k codes kernel differs from its plain "
             f"version: {idx_mism} indices, weights {w_ulps} steps apart")

    # The backward: the kernel's and autograd's through the plain path on
    # one graph each, taken again with retain_graph.
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    wk, _ = sparse_codes.get_weights_and_indices(xk, topk)
    wp, _ = sparse_codes.get_weights_and_indices_plain(xp, topk)
    bwd_k = lambda: torch.autograd.grad(  # noqa: E731
        wk, xk, g, retain_graph=True)[0]
    bwd_p = lambda: torch.autograd.grad(  # noqa: E731
        wp, xp, g, retain_graph=True)[0]
    dk, dp = bwd_k(), bwd_p()
    selected = torch.zeros_like(dk, dtype=torch.bool).scatter_(1, idx, True)
    d_abs = float((dk - dp).abs().max())
    d_err = d_abs / float(dp.abs().max())
    d_bits = int((dk.view(torch.int32) != dp.view(torch.int32)).sum())
    outside = float(dk[~selected].abs().max())
    if d_err > 1e-6 or outside != 0.0:
        fail(f"phase 27: the top-k backward differs from autograd's: "
             f"{d_err:.3g} of the largest, {outside} outside the selection")

    ms, ops = {}, {}
    for name, f, reps in (("kernel", kern, 10), ("plain", plain, 2),
                          ("library", library, 5), ("bwd_kernel", bwd_k, 10),
                          ("bwd_plain", bwd_p, 2)):
        split = device_split(lambda: [f() for _ in range(reps)])
        ms[name] = split["device_total"] / 1e3 / reps
        ops[name] = split["launches"] / reps
    event_ms, _ = cuda_ms(kern, 50)
    bwd_event_ms, _ = cuda_ms(bwd_k, 50)
    rep = kernels.ptxas_report("topk_codes.cu")
    if any(r.get("spill_stores", 0) or r.get("spill_loads", 0) for r in rep):
        fail(f"phase 27: a top-k codes instantiation spills: {rep}")
    occ = {d: kernels.occupancy("lsv2_topk_codes_occupancy", topk, b)
           for d, b in (("forward", 0), ("backward", 1))}

    # A training step's codes: one launch forward, one backward, and no
    # synchronising operation on the way.
    xs = x.clone().requires_grad_(True)
    torch.cuda.synchronize()
    c0 = tracing.counters().get("topk_codes.launches", 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ws, _ = sparse_codes.get_weights_and_indices(xs, topk)
        c1 = tracing.counters().get("topk_codes.launches", 0)
        (ws * g).sum().backward()
        sync = "no synchronising operation"
    except RuntimeError as e:
        sync = f"raised: {str(e).splitlines()[0]}"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    c2 = tracing.counters().get("topk_codes.launches", 0)
    launches = {"forward": c1 - c0, "backward": c2 - c1}
    if sync != "no synchronising operation" or launches != {
            "forward": 1, "backward": 1}:
        fail(f"phase 27: a step's top-k codes: {launches}, {sync}")

    # The kernel's own bytes, each once: the logits read and k f32 weights
    # and int64 indices written; backward the k gradients, weights and
    # indices read and d(logits) written. portbench/roofline.py counts 8 B
    # a code forward, and d(logits) read and written backward.
    fwd_bytes = n * k_all * 4 + n * topk * (4 + 8)
    bwd_bytes = n * topk * (4 + 4 + 8) + n * k_all * 4
    row = dict(ms=ms["kernel"], plain_ms=ms["plain"],
               library_ms=ms["library"],
               max_abs_err=max(float((w - ref_w).abs().max()), d_abs),
               index_mismatches=idx_mism, weight_ulps=w_ulps,
               bwd_ms=ms["bwd_kernel"], bwd_plain_ms=ms["bwd_plain"],
               bwd_rel_err=d_err, bwd_bits_differing=d_bits,
               event_ms=event_ms, bwd_event_ms=bwd_event_ms,
               device_ops=ops, step_launches=launches, sync_debug=sync,
               occupancy=occ, ptxas=rep,
               bound_ms=fwd_bytes / roofline.HBM_BYTES_PER_S * 1e3,
               bound_by="bytes",
               bwd_bound_ms=bwd_bytes / roofline.HBM_BYTES_PER_S * 1e3,
               roofline_bound_ms=roofline.topk_codes(n, k_all, topk) * 1e3,
               roofline_bwd_bound_ms=roofline.pair_grads(n, k_all,
                                                         topk) * 1e3)
    log(f"top-k codes kernel at [{n}, {k_all}], top {topk}: "
        f"{row['ms']:.4f} ms (bound {row['bound_ms']:.4f}; roofline.py "
        f"{row['roofline_bound_ms']:.4f}), plain "
        f"{row['plain_ms']:.3f} ms in {ops['plain']:.0f} device operations, "
        f"library {row['library_ms']:.4f} ms; backward {row['bwd_ms']:.4f} "
        f"ms (bound {row['bwd_bound_ms']:.4f}; roofline.py "
        f"{row['roofline_bwd_bound_ms']:.4f}), autograd's "
        f"{row['bwd_plain_ms']:.3f} ms in {ops['bwd_plain']:.0f}; events "
        f"{event_ms:.4f} / {bwd_event_ms:.4f} ms; weights {w_ulps} steps, "
        f"d(logits) {d_err:.3g} of the largest ({d_bits} elements not bit-"
        f"equal); {occ['forward']['registers']} / "
        f"{occ['backward']['registers']} registers, "
        f"{occ['forward']['warps_per_sm']} / "
        f"{occ['backward']['warps_per_sm']} warps an SM; {sync}")
    del x, xk, xp, xs, wk, wp
    torch.cuda.empty_cache()
    return row


# Phase 28: the geometry cell's shapes (portbench/configs/lerf_rgb_1m.json,
# portbench/traffic/geometry_544x960.json).
GEOM_CAP, GEOM_H, GEOM_W = 1_250_048, 544, 960
# The backward kernel's bytes a Gaussian at SH 3, each once: the 8
# cotangents, mean, scales and rotation and 16 SH rows read (264 B), their
# gradients written (232 B); twice the forward's operations.
PRE_BWD_BYTES = 4 * (8 + 10 + 48) + 4 * (10 + 48)


def preprocess_grad_path(dev) -> dict:
    """Phase 28 (the module docstring). The cotangents are those the
    backward of one rgb_step hands the preprocess (slices of K7's summed
    rows), caught on their way to the kernel with the inputs it read."""
    from langsplatv2_tpu_torch.models.gaussians import GaussianModel
    from portbench import common, roofline_geometry
    from portbench.entries.geometry_step import padded

    cfg = common.load_json(common.HERE / "configs" / "lerf_rgb_1m.json")
    model = GaussianModel(**padded(common.make_scene(cfg, 28, dev),
                                   GEOM_CAP), active_sh_degree=3,
                          max_sh_degree=3, spatial_lr_scale=1.0)
    live = model.live.clone()
    cam = common.Camera(common.camera(4.0, [0.1, -0.05, 0.02], GEOM_W,
                                      GEOM_H, cfg))
    view, projm, campos, bg = trainer.camera_arrays(cam, (0, 0, 0))
    s = make_settings(cam, 3, max_entries=2 ** 23)
    gen = torch.Generator(dev).manual_seed(28)
    gt = torch.rand((3, GEOM_H, GEOM_W), generator=gen, device=dev)
    opt = OptimizationParams(argparse.ArgumentParser())
    optimizer = trainer.make_rgb_optimizer(opt, model)
    counted = {"launches": "preprocess.launches",
               "grad_launches": "preprocess.grad_launches",
               "plain_calls": "preprocess.plain_calls"}

    def step():
        return trainer.rgb_step(s, optimizer, opt.lambda_dssim, model, view,
                                projm, campos, bg, gt, device=dev)

    # One step with the backward launch's arguments caught (copied: Adam
    # updates the model in place after it).
    caught = {}
    launch = projection._grads_launch

    def catch(x, g_xy, g_conic, g_rgb, whole, k):
        caught.update(
            x=x._replace(**{f: getattr(x, f).clone() for f in (
                "means", "scl", "rot", "op", "dc", "rest")}),
            g=tuple(g.clone() for g in (g_xy, g_conic, g_rgb)),
            strides=tuple(g.stride() for g in (g_xy, g_conic, g_rgb)),
            whole=whole, k=k)
        return launch(x, g_xy, g_conic, g_rgb, whole, k)

    projection._grads_launch = catch
    try:
        zero_counts(counted)
        m = step()
        counts = read_counts(counted)
    finally:
        projection._grads_launch = launch
    if counts != {"launches": 1, "grad_launches": 1, "plain_calls": 0}:
        fail(f"phase 28: a geometry step's preprocess counts {counts}")
    if int(m["total_entries"]) >= s.max_entries:
        fail("phase 28: the step saturated its entry budget")
    x, g = caught["x"], caught["g"]
    n = x.n
    args = (x.means, x.scl, x.rot, (x.dc, x.rest), None, view, projm, campos,
            s.tanfovx, s.tanfovy, s.image_width, s.image_height, 3, 1.0)

    # The forward: PreprocessGrad's fields against the plain path's, both
    # under autograd.
    leaves = [t.clone().requires_grad_(True) for t in (x.means, x.scl,
                                                       x.rot, x.dc, x.rest)]
    largs = (*leaves[:3], (leaves[3], leaves[4])) + args[4:]
    fwd = projection.preprocess(*largs, opacities=x.op)
    ref = projection.preprocess_plain(*largs, opacities=x.op)
    mism = {}
    for name in ref._fields:
        a, b = getattr(fwd, name).detach(), getattr(ref, name).detach()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        mism[name] = int((a != b).sum())
    if any(mism.values()):
        fail(f"phase 28: PreprocessGrad's forward differs from the plain "
             f"path under autograd: {mism}")

    # The backward: kernel, plain adjoint, autograd through the plain path.
    kern = lambda: launch(x, *g, False, caught["k"])  # noqa: E731
    plain = lambda: projection.preprocess_grads_plain(  # noqa: E731
        *args, g_xy=g[0], g_conic=g[1], g_rgb=g[2])
    auto = lambda: torch.autograd.grad(  # noqa: E731
        [ref.xy, ref.conic, ref.rgb], leaves, g, retain_graph=True)
    got, want = kern(), plain()
    got = (*got[:3], *got[3])
    want = (*want[:3], *want[3])
    ag = auto()
    errs, auto_errs, max_abs = {}, {}, 0.0
    for name, a, b, c in zip(("means", "scales", "rotations", "dc", "rest"),
                             got, want, ag):
        scale = float(b[live].abs().max())
        errs[name] = float((a - b).abs().max()) / scale
        auto_errs[name] = float((a[live] - c[live]).abs().max()) / float(
            c[live].abs().max())
        max_abs = max(max_abs, float((a - b).abs().max()))
    if max(errs.values()) > 1e-5 or max(auto_errs.values()) > 1e-5:
        fail(f"phase 28: the backward kernel differs: from the plain "
             f"adjoint {errs}, from autograd {auto_errs}")
    busy = int((torch.cat(g, 1) != 0).any(1).sum())

    ms, ops = {}, {}
    fwd_launch = lambda: projection._forward_launch(x, None)  # noqa: E731
    for name, f, reps in (("kernel", kern, 10), ("forward", fwd_launch, 10),
                          ("plain", plain, 2), ("autograd", auto, 2)):
        split = device_split(lambda: [f() for _ in range(reps)])
        ms[name] = split["device_total"] / 1e3 / reps
        ops[name] = split["launches"] / reps
    event_ms, _ = cuda_ms(kern, 50)
    rep = kernels.ptxas_report("preprocess_bwd.cu")
    if any(r.get("spill_stores", 0) or r.get("spill_loads", 0) for r in rep):
        fail(f"phase 28: a preprocess backward instantiation spills: {rep}")
    occ = kernels.occupancy("lsv2_preprocess_bwd_occupancy", 3)

    # A step's device operations on this route and on the parent's (the
    # plain path under autograd).
    step_ops = {"kernels": device_split(step)["launches"]}
    own = projection.preprocess_grad
    projection.preprocess_grad = projection.preprocess_plain
    try:
        step_ops["plain"] = device_split(step)["launches"]
    finally:
        projection.preprocess_grad = own
    row = dict(ms=ms["kernel"], plain_ms=ms["plain"], library_ms=None,
               max_abs_err=max_abs, rel_err_plain=errs,
               rel_err_autograd=auto_errs, forward_ms=ms["forward"],
               autograd_ms=ms["autograd"], device_ops=ops,
               event_ms=event_ms, forward_mismatches=mism,
               cotangent_strides=caught["strides"], gaussians_with_work=busy,
               step_counts=counts, step_device_ops=step_ops,
               occupancy=occ, ptxas=rep,
               roofline_bound_ms=roofline_geometry.preprocess_bwd(n, 3) * 1e3)
    row["bound_ms"], row["bound_by"] = bound(
        n * PRE_BWD_BYTES,
        2 * n * (PRE_FLOPS + PRE_SH_FLOPS * 3 * 16))
    log(f"preprocess backward kernel at {n} slots ({busy} with work), SH 3: "
        f"{row['ms']:.4f} ms (bound {row['bound_ms']:.4f}, "
        f"{row['bound_by']}; roofline_geometry "
        f"{row['roofline_bound_ms']:.4f}), events {event_ms:.4f}; forward "
        f"{ms['forward']:.4f} ms; plain adjoint {ms['plain']:.3f} ms in "
        f"{ops['plain']:.0f} device operations; autograd through the plain "
        f"path {ms['autograd']:.3f} ms in {ops['autograd']:.0f}; relative "
        f"to the plain adjoint {max(errs.values()):.3g}, to autograd "
        f"{max(auto_errs.values()):.3g}; {occ['registers']} registers, "
        f"{occ['blocks_per_sm']} blocks = {occ['warps_per_sm']} warps an "
        f"SM; a step {step_ops['kernels']} device operations "
        f"({step_ops['plain']} on the plain route), counts {counts}")
    del model, optimizer, leaves, fwd, ref
    torch.cuda.empty_cache()
    return row


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("no CUDA device; this script runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {kind}, {torch.cuda.device_count()} visible")

    t0 = time.perf_counter()
    _, build_s = kernels.build()
    kernels.library()
    log(f"kernel build: {build_s:.1f} s ({time.perf_counter() - t0:.1f} s "
        "with load)")
    k2_report = k2_build_report()
    qg_report = qg_build_report()

    errs = check_kernels(dev)

    t0 = time.perf_counter()
    model = from_numpy_params(bench_scene(1_000_000), device=dev)
    clip = OpenCLIPNetwork("hash", device=dev)
    clip.set_positives(PROMPTS)
    consts = clip.prompt_constants(model.codebooks)
    log(f"scene: 1,000,000 Gaussians, {L}x{K}x{DIM} codebooks, "
        f"{L * TOPK} pairs ({time.perf_counter() - t0:.1f} s)")
    path = main_path(model, clip, consts, dev)
    plans = path.pop("plans")
    timing = kernels_at_main_shapes(model, clip, consts, plans, dev)
    bf16 = bf16_serving(model, clip, consts, plans,
                        {k: v["frame_ms_median"]
                         for k, v in path["loads"].items()}, dev)
    fused = fused_query_serving(
        model, clip, consts, plans,
        {name: {v: r["frame_ms_median"] for v, r in load.items()
                if v in ("exact", "capped")}
         for name, load in bf16["loads"].items()}, dev)
    traces = frame_traces(model, clip, consts, plans, dev)
    server = serving_server(model, clip, consts, plans, dev)
    dserve = dense_serving(model, plans, dev)
    cells = bf16_cells_serving(
        model, clip, consts, plans,
        {name: {v: r["frame_ms_median"] for v, r in load.items()
                if v in ("exact", "capped")}
         for name, load in bf16["loads"].items()}, dev)
    casc = cascade_serving(model, clip, consts, plans, path["loads"], dev)
    lmc = lm_capped_chain(
        model, clip, consts, plans,
        {k: v["relevancy_iou"] for k, v in bf16["loads"].items()}, dev)
    p20s = many_prompts_serving(model, plans, dev)
    p20s["K1 edges"] = k1_edge_shapes(dev)
    del model, clip, consts
    torch.cuda.empty_cache()

    train_errs = train_checks_reduced(dev)
    tpath = train_path(dev)
    torch.cuda.empty_cache()
    rgb_errs = rgb_checks_reduced(dev)
    rpath = rgb_path(dev)
    torch.cuda.empty_cache()
    cpath = capped_train_path(dev)
    torch.cuda.empty_cache()
    dpath = dense_path(dev)
    torch.cuda.empty_cache()
    p20t = small_k_training(dev)
    probe_res = cell_probe(dev)
    eval_res = eval_path(dev)
    torch.cuda.empty_cache()
    scene_res = scene_dir_path(dev, smi)
    torch.cuda.empty_cache()
    cli_res = cli_path(dev, smi, eval_res["evaluate_quick"]["gaussians"])
    torch.cuda.empty_cache()
    xla_res = xla_route_path(dev, smi, scene_res)
    torch.cuda.empty_cache()
    pre_res = preprocess_path(dev, smi)
    torch.cuda.empty_cache()
    dist_res = distribution_path(dev, smi)
    pre_row = preprocess_kernel_path(dev)
    topk_row = topk_codes_path(dev)
    pgrad_row = preprocess_grad_path(dev)
    new_rows = {**new_kernel_rows(lmc, probe_res), **dist_res["kernel_rows"],
                "PRE": dict(pre_row,
                            launches=pre_row["frame_counts_4"]["launches"]),
                "TOPK": dict(topk_row, launches=tpath["launches"]["TOPK"]),
                "PREB": dict(pgrad_row, launches=pgrad_row["step_counts"][
                    "grad_launches"]),
                **phase20_kernel_rows(p20s, p20t),
                "K1nocull": dict(
                    xla_res["k1_nocull"]["row"],
                    launches=xla_res["step"]["launches"]["K1nocull"])}

    line = []
    for k, (name, source, replaces) in KERNELS.items():
        if k in ("K1", "K2", "K3"):
            r = timing["1080p"][k]
            launches = path["launches"][k]
            err = max([errs[k]] + [t[k]["max_abs_err"]
                                   for t in timing.values()]
                      + [d[k]["max_abs_err"]
                         for d in (rgb_errs, rpath["kernels"]) if k in d])
            if k == "K2":
                err = max(err, errs["K2 non-finite rows"])
        elif k == "K7":
            r = rpath["kernels"][k]
            launches = rpath["launches"][k]
            err = max(r["max_abs_err"], rgb_errs[k]["max_abs_err"])
        elif k == "K5":
            r = cpath["kernels"][k]
            launches = cpath["launches"][k]
            err = max(r["max_abs_err"], cpath["reduced"]["max_abs_err"])
        elif k in ("K2f16", "K3bf16"):
            loads = bf16["loads"]
            r = loads["1080p"]["exact"][k]
            launches = bf16["launches"][k]
            err = max(v[k]["max_abs_err"] for load in loads.values()
                      for v in (load["exact"], load["capped"]))
            if k == "K2f16":
                err = max([err, errs["K2 non-finite rows"]]
                          + [v["max_abs_err"] for v in
                             server["K2f16_steady"].values()])
        elif k == "K2dense":
            r = dpath["kernels"]["K2dense"]
            launches = dpath["launches"]["K2dense"]
            err = max([r["max_abs_err"]]
                      + [v["max_abs_err"] for v in dpath["reduced"].values()
                         if "channels" in v and "groups" in v]
                      + [v["vs_quick_frame"] for v in dserve.values()])
        elif k in ("K2f16cells", "K2qcells"):
            loads = cells["loads"]
            r = loads["1080p"]["exact"][k]
            launches = cells["launches"]["K2f16" if k == "K2f16cells"
                                         else "K2q"]
            err = max(v[k]["max_abs_err"] for load in loads.values()
                      for v in load.values())
        elif k in ("K8", "K2comb"):
            r = casc["loads"]["1080p"][k]
            launches = casc["launches"]["K8" if k == "K8" else "K2"]
            err = max([v[k]["max_abs_err"] for v in casc["loads"].values()]
                      + ([casc["reduced"]["max_abs_err"]] if k == "K8"
                         else []))
        elif k in new_rows:
            r = new_rows[k]
            launches, err = r["launches"], r["max_abs_err"]
        elif k == "K2q":
            loads = fused["loads"]
            r = loads["1080p"]["exact"][k]
            launches = fused["launches"][k]
            err = max([v[k]["max_abs_err"] for load in loads.values()
                       for v in (load["exact"], load["capped"])]
                      + [server["K2q_steady"]["max_abs_err"]])
        else:
            r = tpath["kernels"][k]
            launches = tpath["launches"][k]
            err = max(r["max_abs_err"], train_errs[k]["max_abs_err"],
                      train_errs["wide"].get(k, 0.0))
            if k == "K4":
                err = max(err, dpath["kernels"]["K4"]["max_abs_err"],
                          dpath["reduced"]["K4 C=192"]["max_abs_err"])
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=err, ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        occ = next((v["occupancy"] for v in k2_report.values()
                    if k in v["rows"]), None)
        qg = {"K3": "K3 f32", "K3bf16": "K3 bf16", "K6a": "K6a kpk=1",
              "K6b": "K6b kpk=1", "K4": "K4", "K4strip": "K4", "K7": "K7",
              "K3pq17": "K3 any f32", "K3bf16pq17": "K3 any bf16",
              "K5": "K5", "K1": "K1 s=0", "K1nocull": "K1 s=0",
              "K1_with_alpha": f"K1 s={CAPPED['subdiv']}",
              "K6aK32": "K6a kpk=1 any", "K6bK32": "K6b kpk=1 any"}
        if k in qg:
            occ = qg_report[qg[k]]["occupancy"]
        if occ is not None:
            log(f"{k}: {r['ms']:.4f} ms on the path's inputs (bound "
                f"{r['bound_ms']:.4f}),"
                f" {occ['blocks_per_sm']} block(s) = {occ['warps_per_sm']} "
                f"warps an SM, {occ['registers']} registers a thread")
    elapsed = time.perf_counter() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(dict(gpu=smi, torch=torch.__version__,
                       cuda=torch.version.cuda, build_s=build_s,
                       elapsed_s=elapsed, max_abs_err_reduced=errs,
                       main_path=path, kernel_timing=timing,
                       train_reduced=train_errs, train_path=tpath,
                       rgb_reduced=rgb_errs, rgb_path=rpath,
                       bf16_serving=bf16, fused_query_serving=fused,
                       serving_server=server, capped_train_path=cpath,
                       dense_path=dpath, dense_serving=dserve,
                       bf16_cells_serving=cells, cascade_serving=casc,
                       k2_build=k2_report, qg_build=qg_report,
                       frame_traces=traces,
                       lm_capped_chain=lmc, cell_probe=probe_res,
                       eval_path=eval_res, many_prompts_serving=p20s,
                       small_k_training=p20t, scene_dir_training=scene_res,
                       command_lines=cli_res, xla_route=xla_res,
                       preprocess=pre_res, distribution=dist_res,
                       preprocess_kernel=pre_row, topk_codes=topk_row,
                       preprocess_grad=pgrad_row),
                  f, indent=1, default=str)
    log(f"chip_smoke: {elapsed:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
