"""Training loops (port of langsplatv2_tpu/train/trainer.py): the geometry
(RGB) phase and the feature phase.

Geometry phase, `train_rgb` (reference train.py:114-267): the six RGB
fields trained against the camera images with (1 - l) L1 + l (1 - SSIM):

    render (RGB mode)             SH colours + preprocess under autograd ->
                                  K1 -> sort -> K2 rgb (bg = 0) with the
                                  background composited outside
    backward of the blend         K7 per-entry rows -> index_add_ -> autograd
                                  through the preprocess, the means2D carrier
    Adam                          six named groups, xyz on its schedule
    densify / prune / reset       host-driven, with capacity growth and
                                  optimizer-state surgery

The step updates the model in place (parameters by Adam, densification
statistics by `add_densification_stats`); densification and the opacity
reset return a new model and rebind the optimizer to its tensors.
`rgb_iteration` is one iteration of the loop (the step and the schedule
around it), which `train_rgb` and the benchmark both call. With
`accum_iter` > 1 the gradients of the live rows and the means2D carrier's
are summed in a carry (`init_rgb_accum`) that Adam applies every
accum_iter-th iteration; the densification statistics read the running
carrier sum, and densification grows and zeroes the carry's rows as it
does the Adam moments. The xyz schedule then reads the true iteration.

Feature phase, `train_features`: geometry frozen, the language logits and
codebooks trained against the camera's ground truth. The cosine-only
configuration runs the loss in Gram space on the compact GT (segment
table + segment map):

    render(include_feature=True)  preprocess -> K1 -> sort -> live-prefix
                                  clamp -> K2 quick [T, 256, L*K] map
    gram_loss_fused               K6a (forward) / K6b (backward)
    backward of the blend         K4 W-replay -> top-k projection ->
                                  index_add_ to d(quick_weights) -> logits
    Adam                          torch.optim.Adam, two named groups

With l1 or normalize the loss is in pixel space (trainer.py:408-421): the
assembled map decoded by `compute_layer_feature_map` up to the curriculum
layer, optionally normalized, and `cos_loss` / `l1_loss` under the mask of
the dense [512, H, W] GT (`Camera.get_language_feature`), on the same
render and backward kernels; there is no dense kernel. The normalize
divides by torch's norm, whose gradient at a zero vector is 0 where JAX's
is NaN (a valid GT pixel no Gaussian covers), so the port stays finite
where the JAX package's parameters turn NaN.

With tile_budget > 0 (the default of scripts/train.sh) and a top-k width of
at most 4, the step takes the budget-capped route instead: K1 -> sort ->
[T, cap] windows and their budget counts -> K2 on the windows, and the
backward K5 (replay fused with the top-k projection) -> index_add_.

`train_features` runs the sequential loop: the camera order from
random.Random(seed), the layer curriculum, the 512-row padding of the
segment table and the adaptive live-prefix budget per camera signature with
its grow-and-redo guard; on the capped route, the expansion budget
(max_entries) per camera signature sized from the first step instead. Where
the JAX step rolls the model back after an overflowing step, the port
decides before the backward and the optimizer step (the forward already
returns live_total and total_entries), so nothing is rolled back and no
gradient of a redone step is ever added. With `accum_iter` > 1 the
gradients sum in `.grad` and Adam steps every accum_iter-th iteration, never
on the last. `cam_batch` > 1 (Gram loss only) runs groups of cameras as
one step (`make_feature_group_step`): the top-k pairs once a group, each
camera's render and loss, the group's budget decision, then one backward
over the cameras (K4 or K5 a camera, their d(quick_weights) summed), one
top-k backward and one Adam step; groups end on absolute multiples of
cam_batch and split at layer changes and `align_iterations`, as in JAX.
The port reports live_total for any top-k width; the JAX package reports it
(and clamps) only where its packed rows fit (L*topk <= 4), so at wider
codes the two keep different budgets with the same results.

One deliberate difference: the JAX trainer accepts a capped step whose
expansion total equals its budget (`tot <= cur`, trainer.py:1033), but the
total is clamped to the budget, so an overflowing camera is truncated
without a redo. The port accepts only a total below the budget and grows
and redoes otherwise (ROADMAP.md Queue 3).

`impl` and `tile_cap` reach every step's settings, as in JAX. Under
impl="xla" both phases render through the rasterizer's XLA route (the
autograd tile blend, tile_cap entries a tile): the geometry step
differentiates through it, the `means2d_dummy` carrier feeding the
densification statistics; the feature steps render the assembled map and
take `gram_cos_loss` (the autograd Gram formulation) on it, as JAX's do
off its tile mode (trainer.py:380-386, :490-494), and keep no live-prefix
budget (the route reports no live_total).

With `gui_source_path` (and `serve/network_gui.init` called), both loops
serve the SIBR viewer's requests at the top of each iteration (a camera
batch: of each group, and again after it), rendered on the trainer's
device from the model as it stands.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device
from ..models import gaussians as gm
from ..models.gaussians import GaussianModel
from ..models.renderer import make_settings, render
from ..ops.gram import gram_loss_fused, seg_to_tiles
from ..ops.projection import BLOCK
from ..ops.train import capped_fits
from ..utils import losses
from ..utils.schedules import expon_lr_func
from .optimizers import (grouped_adam, rebind, set_scheduled_lrs,
                         zero_group_moments, zero_moment_rows)

RGB_PARAM_NAMES = ("xyz", "features_dc", "features_rest", "scaling",
                   "rotation", "opacity")
FEATURE_PARAM_NAMES = ("language_logits", "codebooks")


def _gui_poll(model: GaussianModel, bg_color, iteration: int,
              iterations: int, source_path: str, max_entries: int,
              tile_cap: int, dev) -> None:
    """Serve any pending SIBR viewer request (reference train.py:115-128);
    a no-op unless `serve/network_gui.init` was called. A frame is the
    render clipped to [0, 1], times 255, truncated to u8."""
    from ..serve import network_gui

    if network_gui.listener is None:
        return

    def render_fn(cam, shs_py, cov_py, scaling_mod):
        settings = make_settings(cam, model.active_sh_degree,
                                 scaling_mod or 1.0, max_entries, tile_cap,
                                 16)
        with torch.no_grad():
            out = render(settings, model, cam.world_view_transform,
                         cam.full_proj_transform, cam.camera_center,
                         np.asarray(bg_color, np.float32),
                         convert_shs_python=bool(shs_py),
                         compute_cov3d_python=bool(cov_py), device=dev)
            img = (torch.clamp(out.render, 0.0, 1.0) * 255.0).to(torch.uint8)
        return img.permute(1, 2, 0).cpu().numpy()

    network_gui.poll(render_fn, source_path, iteration, iterations)


def rgb_params(model: GaussianModel) -> dict:
    """The trained parameters of the geometry phase, switched to
    requires_grad."""
    return {k: getattr(model, k).requires_grad_(True)
            for k in RGB_PARAM_NAMES}


def make_rgb_optimizer(opt, model: GaussianModel,
                       accum_iter: int = 1) -> torch.optim.Adam:
    """Six groups with the reference rates (gaussian_model.py:244-257); the
    xyz rate follows expon_lr_func scaled by the model's spatial_lr_scale,
    at the true iteration: update u (1-based) happens at iteration
    u * accum_iter."""
    scale = model.spatial_lr_scale
    schedule = expon_lr_func(
        lr_init=opt.position_lr_init * scale,
        lr_final=opt.position_lr_final * scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps)

    def xyz_schedule(update: int) -> float:
        return schedule(update * accum_iter)

    rates = {"xyz": xyz_schedule, "features_dc": opt.feature_lr,
             "features_rest": opt.feature_lr / 20.0,
             "opacity": opt.opacity_lr, "scaling": opt.scaling_lr,
             "rotation": opt.rotation_lr}
    return grouped_adam({k: (p, rates[k])
                         for k, p in rgb_params(model).items()})


def feature_params(model: GaussianModel) -> dict:
    """The trained parameters of the feature phase, switched to
    requires_grad."""
    return {k: getattr(model, k).requires_grad_(True)
            for k in FEATURE_PARAM_NAMES}


def make_feature_optimizer(opt, model: GaussianModel) -> torch.optim.Adam:
    """One learning rate for logits and codebooks (the reference's
    gaussian_model.py:234-238)."""
    return grouped_adam({k: (p, opt.language_feature_lr)
                         for k, p in feature_params(model).items()})


# ------------------------------------------------------- the geometry step

def init_rgb_accum(model: GaussianModel) -> dict:
    """The geometry phase's accumulation carry: zero gradients of the six
    fields and of the means2D carrier [C, 2]."""
    return {"grads": {k: torch.zeros_like(getattr(model, k))
                      for k in RGB_PARAM_NAMES},
            "means2d": torch.zeros((model.capacity, 2),
                                   device=model.xyz.device)}


def rgb_step(settings, optimizer: torch.optim.Optimizer, lambda_dssim: float,
             model, view, proj, campos, bg, gt_image, device=None,
             accum: dict | None = None, do_update: bool = True) -> dict:
    """One geometry step: render in RGB mode with a zero means2D carrier,
    the loss (1 - lambda_dssim) L1 + lambda_dssim (1 - SSIM), the backward,
    the gradients of dead (padding) rows hard-zeroed (masked branches can
    carry NaN there: a dead row's depth is 0), the scheduled rates, Adam,
    and the densification statistics of the visible Gaussians. The model
    is updated in place; the gradients stay in `.grad`. Returns the
    step's metrics.

    With an `accum` carry (init_rgb_accum) the step's gradients are added
    to it and Adam applies the carry's sums, then zeroes it, only when
    `do_update`; the statistics read the carrier's running sum.

    Spans (tracing.py): "step" over "forward" (the render), "loss",
    "backward", "optimizer" (the dead-row mask, the carry, the scheduled
    rates and Adam) and "densify_stats" (max radii and the statistics)."""
    with tracing.span("step"):
        with tracing.span("forward"):
            dummy = torch.zeros((model.capacity, 2), device=model.xyz.device,
                                requires_grad=True)
            out = render(settings, model, view, proj, campos, bg,
                         means2d_dummy=dummy, device=device)
        with tracing.span("loss"):
            l1 = losses.l1_loss(out.render, gt_image)
            loss = (1.0 - lambda_dssim) * l1 + lambda_dssim * (
                1.0 - losses.ssim(out.render, gt_image))
        with tracing.span("backward"):
            optimizer.zero_grad(set_to_none=False)
            loss.backward()
        with tracing.span("optimizer"):
            dead = ~model.live
            for name in RGB_PARAM_NAMES:
                g = getattr(model, name).grad
                g.masked_fill_(dead.reshape((-1,) + (1,) * (g.dim() - 1)),
                               0.0)
            means2d = dummy.grad
            if accum is not None:
                with torch.no_grad():
                    for name in RGB_PARAM_NAMES:
                        acc = accum["grads"][name]
                        acc += getattr(model, name).grad
                        if do_update:
                            getattr(model, name).grad.copy_(acc)
                    accum["means2d"] += dummy.grad
                    means2d = accum["means2d"].clone()
            if accum is None or do_update:
                set_scheduled_lrs(optimizer)
                optimizer.step()
                if accum is not None:
                    for t in (*accum["grads"].values(), accum["means2d"]):
                        t.zero_()
        with tracing.span("densify_stats"):
            vis = out.visibility_filter
            with torch.no_grad():
                model.max_radii2d.copy_(torch.where(
                    vis, torch.maximum(model.max_radii2d, out.radii.float()),
                    model.max_radii2d))
            gm.add_densification_stats(model, means2d, vis)
    return {"loss": loss.detach(), "l1": l1.detach(),
            "num_visible": vis.sum(), "max_tile_count": out.max_tile_count,
            "total_entries": out.total_entries, "means2d_grad": dummy.grad}


def _carry_rows(carry, fn):
    """Replace every tensor t of the accumulation carry by fn(t)."""
    if carry is not None:
        carry["grads"] = {k: fn(v) for k, v in carry["grads"].items()}
        carry["means2d"] = fn(carry["means2d"])


def run_densify(model: GaussianModel, optimizer: torch.optim.Optimizer,
                generator: torch.Generator, opt, extent: float,
                max_screen_size: float,
                carry: dict | None = None) -> GaussianModel:
    """One densification round with capacity growth on overflow (the
    capacity grows to max(C + overflow, 1.5 C), rounded up to 256, and the
    round is redone), the Adam moments of reused slots zeroed and the
    optimizer rebound to the new model's tensors. The split noise comes
    from `generator`, one draw per attempt. The tensors of `carry` (the
    accumulation carry) get the moments' row surgery in place.

    Counters (tracing.py): "densify.rounds" once a call,
    "densify.capacity_growths" once a growth, and "densify.placed" /
    "densify.pruned" the round's new Gaussians and removed ones, read in
    the one copy to the host that the overflow already takes."""
    tracing.count("densify.rounds")
    n_before = model.num_live
    while True:
        eps = torch.randn((2, model.capacity, 3), generator=generator,
                          device=generator.device).to(model.xyz.device)
        new_model, overflow, placed = gm.densify_and_prune(
            model, eps, max_grad=opt.densify_grad_threshold,
            min_opacity=0.005, extent=extent,
            max_screen_size=max_screen_size,
            percent_dense=opt.percent_dense)
        n_placed = placed.sum()
        # Live after = live before - pruned + placed.
        overflow, n_placed, n_pruned = torch.stack([
            overflow, n_placed, n_before - new_model.num_live + n_placed
        ]).tolist()
        if overflow == 0:
            tracing.count("densify.placed", n_placed)
            tracing.count("densify.pruned", n_pruned)
            zero_moment_rows(optimizer, placed)
            rebind(optimizer, rgb_params(new_model))
            _carry_rows(carry, lambda t: t.masked_fill(
                placed.reshape((-1,) + (1,) * (t.dim() - 1)), 0.0))
            return new_model
        tracing.count("densify.capacity_growths")
        old_cap = model.capacity
        new_cap = -(-max(old_cap + overflow, int(old_cap * 1.5)) // 256) * 256
        model = gm.grow_capacity(model, new_cap)
        rebind(optimizer, rgb_params(model))
        _carry_rows(carry, lambda t: gm._pad(t, new_cap))


def apply_opacity_reset(model: GaussianModel,
                        optimizer: torch.optim.Optimizer) -> GaussianModel:
    """reset_opacity and zero the opacity group's Adam moments (reference
    gaussian_model.py:308-311 + replace_tensor_to_optimizer)."""
    model = gm.reset_opacity(model)
    rebind(optimizer, rgb_params(model))
    zero_group_moments(optimizer, "opacity")
    return model


# ---------------------------------------------------------------- the loss

def gram_cos_loss(codebooks, weight_map, gt_table, seg_map, layer_idx,
                  eps: float = 1e-8):
    """The reference cosine loss cos_loss(feat * mask, gt * mask) on an
    image-layout map [L*K, H, W], computed in K-dim Gram space."""
    L, K, _ = codebooks.shape
    H, W = seg_map.shape
    w = weight_map.reshape(L, K, H * W)
    return _gram_cos_core(codebooks, w, seg_map.reshape(-1), H * W,
                          int(layer_idx), eps=eps, gt_table=gt_table)


def gram_cos_loss_tiles(codebooks, wmap_tiles, gt_table, seg_map, layer_idx,
                        eps: float = 1e-8):
    """gram_cos_loss on a tile-layout map [T, 256, L*K]; padding pixels
    carry segment -1 (sim 0)."""
    L, K, _ = codebooks.shape
    H, W = seg_map.shape
    t, p, _ = wmap_tiles.shape
    seg_t = seg_to_tiles(seg_map, -(-W // BLOCK), -(-H // BLOCK)).reshape(-1)
    w = wmap_tiles.reshape(t * p, L, K).permute(1, 2, 0)      # [L, K, Q]
    return _gram_cos_core(codebooks, w, seg_t, H * W, int(layer_idx),
                          eps=eps, gt_table=gt_table)


def _gram_cos_core(codebooks, w, seg_flat, hw: int, lay: int, *, eps: float,
                   gt_table, reduce: str = "mean"):
    """The XLA formulation, differentiated by autograd: w [L, K, Q]
    coefficients in any pixel order, seg_flat [Q] (-1 = masked or
    padding), hw the pixel count the mean divides by. Layers below `lay`
    enter detached. The JAX one-hot matmul lookup is an exact row selection;
    here it is a gather. reduce="mean" returns the loss 1 - sum(sim) / hw;
    reduce="sum" the raw sum(sim), so that tile shards can add their
    partial sums before they normalize (the loss is linear in them)."""
    if reduce not in ("mean", "sum"):
        raise ValueError(f"unknown reduce {reduce!r}")
    K = codebooks.shape[1]
    q = seg_flat.shape[0]
    cbs = [codebooks[i].detach() if i < lay else codebooks[i]
           for i in range(lay + 1)]
    ws = [w[i].detach() if i < lay else w[i] for i in range(lay + 1)]
    phis = [gt_table @ c.T for c in cbs]                      # [S, K] each
    gt_n = torch.linalg.norm(gt_table, dim=1, keepdim=True)   # [S, 1]
    rhs = torch.cat(phis + [gt_n], dim=1)                     # [S, M+1]
    valid = seg_flat >= 0
    looked = torch.where(valid[:, None], rhs[seg_flat.clamp(min=0).long()],
                         0.0)                                 # [Q, M+1]
    gt_n_pix = looked[:, -1]
    num = torch.zeros(q, device=w.device)
    for i in range(lay + 1):
        num = num + (ws[i] * looked[:, i * K:(i + 1) * K].T).sum(0)
    n2 = torch.zeros(q, device=w.device)
    for i in range(lay + 1):
        for j in range(lay + 1):
            gij = cbs[i] @ cbs[j].T                           # [K, K]
            n2 = n2 + (ws[i] * (gij @ ws[j])).sum(0)
    # sqrt has an infinite derivative at 0: uncovered pixels (n2 == 0)
    # would send NaN through the eps clamp.
    covered = n2 > 0
    nrm = torch.where(covered, torch.sqrt(torch.where(covered, n2, 1.0)),
                      0.0)
    sim = num / (torch.clamp(nrm, min=eps) * torch.clamp(gt_n_pix, min=eps))
    if reduce == "sum":
        return sim.sum()
    return 1.0 - sim.sum() / hw


# ---------------------------------------------------------------- the steps

def pixel_loss(model, weight_map, gt_feature, feature_mask, layer_idx: int,
               use_cos_loss: bool, use_l1_loss: bool, normalize: bool):
    """The reference's pixel-space feature loss (train.py:146-167): the
    [L*K, H, W] map decoded up to `layer_idx`, optionally normalized per
    pixel, against the [512, H, W] GT under its mask. Returns (loss,
    l1)."""
    feat = model.compute_layer_feature_map(weight_map, layer_idx)
    if normalize:
        feat = feat / (torch.linalg.norm(feat, dim=0, keepdim=True) + 1e-10)
    mask = feature_mask.to(feat.dtype)
    pred, gt = feat * mask, gt_feature * mask
    loss = torch.zeros((), device=feat.device)
    l1 = torch.zeros((), device=feat.device)
    if use_cos_loss:
        loss = loss + losses.cos_loss(pred, gt)
    if use_l1_loss:
        l1 = losses.l1_loss(pred, gt)
        loss = loss + l1
    return loss, l1


def _accepted(accept: Callable | None, metrics: dict) -> bool:
    """The guard's decision on a formed step, in the span "accept" (the
    host waits there on the device's totals); a refusal counts as
    "feature_step.redone"."""
    if accept is None:
        return True
    with tracing.span("accept"):
        ok = accept(metrics)
    if not ok:
        tracing.count("feature_step.redone")
    return ok


def _apply(model, optimizer, do_update: bool, accumulate: bool) -> None:
    """After a step's backward: zero the logits' gradient on dead rows,
    then step Adam when `do_update` (the gradients accumulated since the
    last update when `accumulate`, which are then cleared)."""
    model.language_logits.grad.masked_fill_(~model.live[:, None], 0.0)
    if do_update:
        optimizer.step()
        if accumulate:
            optimizer.zero_grad(set_to_none=False)


def make_feature_train_step(settings, optimizer: torch.optim.Optimizer,
                            topk: int, use_cos_loss: bool = True,
                            use_l1_loss: bool = False,
                            normalize: bool = False):
    """The feature step. The cosine-only configuration keeps the map in
    tile layout for the fused Gram loss (K6a/K6b) on the compact GT
    (gt_a, gt_b = segment table, segment map); l1 or normalize take the
    pixel-space loss on the assembled map and the dense GT (gt_a, gt_b =
    [512, H, W] features, [1, H, W] mask).

    Returns step(model, view, proj, campos, bg, gt_a, gt_b, layer_idx=0,
    accept=None, device=None, do_update=True, accumulate=False) ->
    (metrics, applied). The forward runs first; when `accept(metrics)`
    says no, the step returns without a backward or an update (the
    trainer's redo; the counter "feature_step.redone" counts it).
    Otherwise the gradients of logits and codebooks are formed (added to
    `.grad` when `accumulate`, else replacing it), the logits' zeroed on
    dead rows, and Adam steps when `do_update`. The step's spans
    (tracing.py): "step" over "forward", "loss", "accept", "backward" and
    "optimizer"."""
    gram = use_cos_loss and not use_l1_loss and not normalize
    # The kernel routes keep the map in tile layout for K6; the XLA route
    # assembles it, and the Gram loss is then the autograd formulation
    # (trainer.py:380-386).
    tiles = gram and settings.impl != "xla"
    render_settings = settings._replace(assemble=False) if tiles else settings

    def step(model, view, proj, campos, bg, gt_a, gt_b, layer_idx: int = 0,
             accept: Callable | None = None, device=None,
             do_update: bool = True, accumulate: bool = False):
        with tracing.span("step"):
            with tracing.span("forward"):
                out = render(render_settings, model, view, proj, campos, bg,
                             include_feature=True, topk=topk, device=device)
            with tracing.span("loss"):
                if gram:
                    loss = (gram_loss_fused if tiles else gram_cos_loss)(
                        model.codebooks, out.language_feature_weight_map,
                        gt_a, gt_b, layer_idx)
                    l1 = torch.zeros((), device=loss.device)
                else:
                    loss, l1 = pixel_loss(
                        model, out.language_feature_weight_map, gt_a, gt_b,
                        layer_idx, use_cos_loss, use_l1_loss, normalize)
                metrics = {"loss": loss.detach(), "l1": l1.detach(),
                           "live_total": out.live_total,
                           "total_entries": out.total_entries}
            if not _accepted(accept, metrics):
                return metrics, False
            with tracing.span("backward"):
                if not accumulate:
                    optimizer.zero_grad(set_to_none=False)
                loss.backward()
            with tracing.span("optimizer"):
                _apply(model, optimizer, do_update, accumulate)
            return metrics, True

    return step


def make_feature_group_step(settings, optimizer: torch.optim.Optimizer,
                            topk: int):
    """The camera-batched feature step (the JAX
    make_feature_train_step_batched), Gram loss only: accumulation
    semantics over a group of cameras with the top-k pairs formed once.

    Returns step(model, views, bg, gts, layer_idx=0, accept=None,
    device=None, do_update=True) -> (metrics, applied), `views` a list of
    (view, proj, campos) and `gts` of (segment table, segment map), one a
    camera. Each camera is rendered on the group's (weights, indices) and
    its loss formed; `accept` sees the group's largest live_total and
    total_entries before any gradient exists. Then one backward over the
    group's losses (the blend backward a camera, their d(quick_weights)
    summed), one backward of the top-k projection, the logits' gradient
    zeroed on dead rows and one Adam step when `do_update`. metrics
    "losses" holds each camera's loss. Counter and spans as for
    `make_feature_train_step` (a "forward" and a "loss" a camera)."""
    tiles = settings.impl != "xla"
    render_settings = settings._replace(assemble=False) if tiles else settings
    loss_fn = gram_loss_fused if tiles else gram_cos_loss

    def step(model, views, bg, gts, layer_idx: int = 0,
             accept: Callable | None = None, device=None,
             do_update: bool = True):
        with tracing.span("step"):
            with tracing.span("forward"):
                qw, qi = model.get_weights_and_indices(topk)
                qw_group = qw.detach().requires_grad_(True)
            group_losses, lives, totals = [], [], []
            for (view, proj, campos), (table, seg) in zip(views, gts):
                with tracing.span("forward"):
                    out = render(render_settings, model, view, proj, campos,
                                 bg, include_feature=True, topk=topk,
                                 precomputed_quick=(qw_group, qi),
                                 device=device)
                with tracing.span("loss"):
                    group_losses.append(loss_fn(
                        model.codebooks, out.language_feature_weight_map,
                        table, seg, layer_idx))
                lives.append(out.live_total)
                totals.append(out.total_entries)
            with tracing.span("loss"):
                per_camera = torch.stack([v.detach() for v in group_losses])
                metrics = {"loss": per_camera.sum(), "losses": per_camera,
                           "live_total": (None if lives[0] is None
                                          else torch.stack(lives).max()),
                           "total_entries": torch.stack(totals).max()}
            if not _accepted(accept, metrics):
                return metrics, False
            with tracing.span("backward"):
                optimizer.zero_grad(set_to_none=False)
                torch.autograd.backward(group_losses)
                qw.backward(qw_group.grad)
            with tracing.span("optimizer"):
                _apply(model, optimizer, do_update, False)
            return metrics, True

    return step


# ---------------------------------------------------------------- the loops

@dataclass
class TrainLogs:
    losses: list = field(default_factory=list)
    ema_loss: float = 0.0
    live_budget: dict = field(default_factory=dict)   # camera sig -> budget
    exp_budget: dict = field(default_factory=dict)    # capped: sig -> budget
    events: list = field(default_factory=list)   # (iteration, kind, num_live)


def camera_arrays(camera, bg):
    """(view, proj, campos, bg) as float32 numpy arrays."""
    return (np.asarray(camera.world_view_transform, np.float32),
            np.asarray(camera.full_proj_transform, np.float32),
            np.asarray(camera.camera_center, np.float32),
            np.asarray(bg, np.float32))


def rgb_iteration(iteration: int, model: GaussianModel,
                  optimizer: torch.optim.Optimizer, cam, image, opt,
                  extent: float, generator: torch.Generator, logs: TrainLogs,
                  *, iterations: int, bg_color=(0, 0, 0),
                  white_background: bool = False, tile_cap: int = 1024,
                  max_entries: int = 2 ** 21, accum: dict | None = None,
                  accum_iter: int = 1, impl: str = "auto", device=None):
    """Iteration `iteration` of the geometry phase (reference
    train.py:170-258) on camera `cam` and its image [3, H, W] on the
    device: the SH step-up every 1000 iterations, the step (`rgb_step`,
    Adam every accum_iter-th iteration and never on the last), the loss
    logged, then the densification schedule: a round (`run_densify`, in
    the span "densify") every `opt.densification_interval` iterations
    after `opt.densify_from_iter` and before `opt.densify_until_iter`, its
    size threshold on after the first opacity reset, and the opacity reset
    (in the span "opacity_reset") every `opt.opacity_reset_interval`
    iterations (and at densify_from_iter with a white background); both
    are logged in `logs.events`. Returns (the model, new after a round or
    a reset, and the step's metrics)."""
    if iteration % 1000 == 0:
        model.one_up_sh_degree()
    settings = make_settings(cam, model.active_sh_degree, 1.0, max_entries,
                             tile_cap, 16, impl=impl)
    view, proj, campos, bg = camera_arrays(cam, bg_color)
    metrics = rgb_step(
        settings, optimizer, opt.lambda_dssim, model, view, proj, campos, bg,
        image, device=device, accum=accum,
        do_update=iteration < iterations and iteration % accum_iter == 0)
    loss = float(metrics["loss"])
    logs.ema_loss = 0.4 * loss + 0.6 * logs.ema_loss
    logs.losses.append(loss)

    # Densification schedule (reference train.py:246-258).
    if iteration < opt.densify_until_iter:
        if (iteration > opt.densify_from_iter
                and iteration % opt.densification_interval == 0):
            size_threshold = (20.0 if iteration
                              > opt.opacity_reset_interval else 0.0)
            with tracing.span("densify"):
                model = run_densify(model, optimizer, generator, opt, extent,
                                    size_threshold, carry=accum)
            logs.events.append((iteration, "densify", int(model.num_live)))
        if iteration % opt.opacity_reset_interval == 0 or (
                white_background and iteration == opt.densify_from_iter):
            with tracing.span("opacity_reset"):
                model = apply_opacity_reset(model, optimizer)
                if accum is not None:
                    accum["grads"]["opacity"].zero_()
            logs.events.append((iteration, "opacity_reset", None))
    return model, metrics


def train_rgb(
    model: GaussianModel,
    cameras: list,
    opt,
    extent: float,
    *,
    iterations: int | None = None,
    first_iter: int = 0,
    bg_color=(0, 0, 0),
    white_background: bool = False,
    seed: int = 0,
    tile_cap: int = 1024,
    max_entries: int = 2 ** 21,
    accum_iter: int = 1,
    optimizer: torch.optim.Optimizer | None = None,
    on_iteration: Callable[[int, GaussianModel, Any, dict], None] | None
    = None,
    gui_source_path: str | None = None,
    impl: str = "auto",
    device=None,
):
    """The geometry phase's loop (reference train.py:114-267). Returns
    (model, optimizer, logs); `logs.events` lists (iteration, "densify",
    num_live) and (iteration, "opacity_reset", None).

    Each camera carries its image [3, H, W] in `camera.image`. The SH
    degree steps up every 1000 iterations; densification runs every
    `opt.densification_interval` iterations after `opt.densify_from_iter`
    and before `opt.densify_until_iter`, its split noise drawn from a
    torch.Generator on the device seeded with `seed`. With `accum_iter` >
    1 Adam steps every accum_iter-th iteration on the summed gradients,
    never on the last iteration (reference train.py:261).
    `on_iteration(iteration, model, optimizer, metrics)` runs after each
    step and any densification. The camera order and the images are this
    loop's; each iteration is `rgb_iteration`."""
    dev = resolve_device(device)
    if model.xyz.device.type != dev.type:
        raise ValueError(f"the model lies on {model.xyz.device}, not {dev}")
    iterations = iterations or opt.iterations
    if optimizer is None:
        optimizer = make_rgb_optimizer(opt, model, accum_iter)
    accum = init_rgb_accum(model) if accum_iter > 1 else None
    generator = torch.Generator(device=dev).manual_seed(seed)
    rng = random.Random(seed)
    logs = TrainLogs()
    images: dict[int, torch.Tensor] = {}

    viewpoint_stack: list = []
    for iteration in range(first_iter + 1, iterations + 1):
        if gui_source_path is not None:
            _gui_poll(model, bg_color, iteration, iterations,
                      gui_source_path, max_entries, tile_cap, dev)
        if not viewpoint_stack:
            viewpoint_stack = list(cameras)
        cam = viewpoint_stack.pop(rng.randint(0, len(viewpoint_stack) - 1))
        if id(cam) not in images:
            images[id(cam)] = torch.as_tensor(
                np.asarray(cam.image, np.float32), device=dev)
        model, metrics = rgb_iteration(
            iteration, model, optimizer, cam, images[id(cam)], opt, extent,
            generator, logs, iterations=iterations, bg_color=bg_color,
            white_background=white_background, tile_cap=tile_cap,
            max_entries=max_entries, accum=accum, accum_iter=accum_iter,
            impl=impl, device=dev)
        if on_iteration is not None:
            on_iteration(iteration, model, optimizer, metrics)
    return model, optimizer, logs


def train_features(
    model: GaussianModel,
    cameras: list,
    opt,
    lf_dir: str,
    feature_level: int,
    *,
    iterations: int = 10_000,
    first_iter: int = 0,
    topk: int = 4,
    use_cos_loss: bool = True,
    use_l1_loss: bool = False,
    normalize: bool = False,
    bg_color=(0, 0, 0),
    seed: int = 0,
    tile_cap: int = 1024,
    max_entries: int = 2 ** 21,
    accum_iter: int = 1,
    cam_batch: int = 1,
    align_iterations=(),
    tile_budget: float = 0.0,
    tile_budget_cap: int = 128,
    tile_budget_subdiv: int = 2,
    cull_alpha: float = 1.0 / 255.0,
    impl: str = "auto",
    optimizer: torch.optim.Optimizer | None = None,
    feature_cache: dict | None = None,
    on_iteration: Callable[[int, GaussianModel, Any, dict], None] | None
    = None,
    gui_source_path: str | None = None,
    device=None,
):
    """The feature phase's loop (reference train.py language branch).
    Returns (model, optimizer, logs); the model's logits and codebooks are
    updated in place. The cosine-only configuration trains in Gram space
    on the compact GT, l1 / normalize in pixel space on the dense GT.
    `tile_budget` > 0 takes the capped route where the top-k width
    (L * topk) is at most 4, as the JAX package does; `logs.exp_budget`
    then records the expansion budget per camera signature.

    `accum_iter` > 1 sums gradients over accum_iter iterations; `cam_batch`
    > 1 (cosine-only, one camera signature, not with accum_iter) runs
    groups of cameras as one step, and `align_iterations` lists the
    iterations whose `on_iteration` persists or evaluates state, which then
    end a group (a mid-group callback sees the group-end state).
    `feature_cache` maps camera.image_name -> GT tensors (pass {} to keep
    them across epochs); `on_iteration(iteration, model, optimizer,
    metrics)` runs after each step."""
    if model.language_logits is None or model.codebooks is None:
        raise ValueError("train_features needs language logits and "
                         "codebooks (init_language_features)")
    gram = use_cos_loss and not use_l1_loss and not normalize
    if cam_batch > 1:
        if not gram:
            raise ValueError(
                "cam_batch > 1 requires the gram (cosine-only) config "
                "(--cos_loss without --l1_loss/--normalize)")
        if accum_iter != 1:
            raise ValueError("cam_batch already accumulates; combining with "
                             "accum_iter is unsupported")
    dev = resolve_device(device)
    if model.xyz.device.type != dev.type:
        raise ValueError(f"the model lies on {model.xyz.device}, not {dev}")
    if optimizer is None:
        optimizer = make_feature_optimizer(opt, model)
    optimizer.zero_grad(set_to_none=True)
    rng = random.Random(seed)
    logs = TrainLogs()
    layer_num = model.codebooks.shape[0]
    capped = tile_budget > 0.0 and capped_fits(layer_num * topk)
    # Live-prefix budget per camera signature: 0 = full budget (the first
    # step of a signature measures live_total); a later viewpoint whose
    # live_total overflows the budget grows it and redoes its step. The
    # capped route has no live prefix (its windows are fixed-size); it
    # sizes the expansion buffer per signature the same way instead.
    # tile_budget > 0 at a wider code runs the exact route with neither
    # budget, as in JAX (its telemetry there is off).
    live_budget, exp_budget = logs.live_budget, logs.exp_budget

    def _grow_budget(lt: int) -> int:
        return min(max_entries, -(-int(lt * 1.3 + 32768) // 65536) * 65536)

    def cam_sig(camera):
        return (camera.image_height, camera.image_width,
                round(camera.tanfovx, 9), round(camera.tanfovy, 9))

    def get_settings(camera, sig):
        live = 0 if tile_budget > 0.0 else live_budget.get(sig, 0)
        ebud = exp_budget.get(sig, max_entries) if capped else max_entries
        return make_settings(
            camera, model.active_sh_degree, 1.0, ebud, tile_cap, 16,
            impl=impl, live_entries=live,
            tile_budget=tile_budget, tile_budget_cap=tile_budget_cap,
            tile_budget_subdiv=tile_budget_subdiv, cull_alpha=cull_alpha)

    def budget_check(sig):
        budgets, key = ((exp_budget, "total_entries") if capped
                        else (live_budget, "live_total"))

        def accept(metrics) -> bool:
            if (tile_budget > 0.0 and not capped) or metrics[key] is None:
                return True     # the XLA route keeps no live prefix
            n = int(metrics[key])
            cur = budgets.get(sig, 0)
            if cur == 0:
                # The first step ran at the full budget (exact): tighten
                # for the rest of the run.
                budgets[sig] = _grow_budget(n)
                return True
            # The live prefix holds live_total <= cur entries; the
            # expansion total is clamped to its budget, so only a total
            # below it shows that nothing was cut. At max_entries there is
            # nothing to grow into: an overflow then shows in the step's
            # total_entries, as on the exact route.
            if ((n < cur) if capped else (n <= cur)) or cur == max_entries:
                return True
            # Real entries would be dropped: grow and redo.
            budgets[sig] = _grow_budget(n)
            return False
        return accept

    def curriculum_layer(it):
        return min(int(it / 10000 * layer_num), layer_num - 1)

    def get_gt(cam):
        if feature_cache is not None and cam.image_name in feature_cache:
            return feature_cache[cam.image_name]
        if gram:
            table, seg = cam.get_language_feature_compact(lf_dir,
                                                          feature_level)
            # A coarse 512-row grid of table sizes (padded rows are never
            # selected by any segment id).
            s_pad = -(-max(table.shape[0], 1) // 512) * 512
            pair = (np.pad(table, ((0, s_pad - table.shape[0]), (0, 0))),
                    np.ascontiguousarray(seg))
        else:
            pair = cam.get_language_feature(lf_dir, feature_level)
        pair = tuple(torch.from_numpy(a).to(dev) for a in pair)
        if feature_cache is not None:
            feature_cache[cam.image_name] = pair
        return pair

    def record(iteration, metrics):
        loss = float(metrics["loss"])
        logs.ema_loss = 0.4 * loss + 0.6 * logs.ema_loss
        logs.losses.append(loss)
        if on_iteration is not None:
            on_iteration(iteration, model, optimizer, metrics)

    def next_camera(stack):
        if not stack:
            stack.extend(cameras)
        return stack.pop(rng.randint(0, len(stack) - 1))

    viewpoint_stack: list = []
    if cam_batch > 1:
        if len({cam_sig(c) for c in cameras}) != 1:
            raise ValueError(
                "cam_batch > 1 needs one shared camera (H, W, fov) signature "
                f"across the dataset; got {len({cam_sig(c) for c in cameras})}")
        align = set(align_iterations or ())
        iteration = first_iter + 1
        while iteration <= iterations:
            if gui_source_path is not None:
                _gui_poll(model, bg_color, iteration, iterations,
                          gui_source_path, max_entries, tile_cap, dev)
            layer_idx = curriculum_layer(iteration)
            # Up to the next absolute multiple of cam_batch, clamped by the
            # iterations left, the curriculum layer and any align mark.
            g_max = cam_batch - ((iteration - 1) % cam_batch)
            g = 1
            while (g < g_max and iteration + g <= iterations
                   and curriculum_layer(iteration + g) == layer_idx
                   and (iteration + g - 1) not in align):
                g += 1
            cams = [next_camera(viewpoint_stack) for _ in range(g)]
            sig = cam_sig(cams[0])
            arrays = [camera_arrays(c, bg_color) for c in cams]
            views = [a[:3] for a in arrays]
            gts = [get_gt(c) for c in cams]
            applied = False
            while not applied:
                step = make_feature_group_step(get_settings(cams[0], sig),
                                               optimizer, topk)
                metrics, applied = step(
                    model, views, arrays[0][3], gts, layer_idx,
                    accept=budget_check(sig), device=dev,
                    do_update=iteration + g - 1 < iterations)
            if gui_source_path is not None:
                # A group spans up to cam_batch iterations of wall time:
                # poll after its step too.
                _gui_poll(model, bg_color, iteration + g - 1, iterations,
                          gui_source_path, max_entries, tile_cap, dev)
            for j in range(g):
                record(iteration + j, {
                    "loss": metrics["losses"][j],
                    "live_total": metrics["live_total"],
                    "total_entries": metrics["total_entries"]})
            iteration += g
        return model, optimizer, logs

    accumulate = accum_iter > 1
    for iteration in range(first_iter + 1, iterations + 1):
        if gui_source_path is not None:
            _gui_poll(model, bg_color, iteration, iterations,
                      gui_source_path, max_entries, tile_cap, dev)
        cam = next_camera(viewpoint_stack)
        layer_idx = curriculum_layer(iteration)
        sig = cam_sig(cam)
        view, proj, campos, bg = camera_arrays(cam, bg_color)
        gt_a, gt_b = get_gt(cam)
        do_update = not accumulate or (iteration < iterations
                                       and iteration % accum_iter == 0)
        applied = False
        while not applied:
            step = make_feature_train_step(
                get_settings(cam, sig), optimizer, topk, use_cos_loss,
                use_l1_loss, normalize)
            metrics, applied = step(
                model, view, proj, campos, bg, gt_a, gt_b, layer_idx,
                accept=budget_check(sig), device=dev, do_update=do_update,
                accumulate=accumulate)
        record(iteration, metrics)
    return model, optimizer, logs
