"""Feature-phase training, exact route (port of
langsplatv2_tpu/train/trainer.py:36-68, 220-465, 592-605, 742-1056).

Geometry frozen, the language logits and codebooks trained against the
compact GT (segment table + segment map) with the cosine loss in Gram space:

    render(include_feature=True)  preprocess -> K1 -> sort -> live-prefix
                                  clamp -> K2 quick [T, 256, L*K] map
    gram_loss_fused               K6a (forward) / K6b (backward)
    backward of the blend         K4 W-replay -> top-k projection ->
                                  index_add_ to d(quick_weights) -> logits
    Adam                          torch.optim.Adam, two named groups

`train_features` runs the sequential loop: the camera order from
random.Random(seed), the layer curriculum, the 512-row padding of the
segment table and the adaptive live-prefix budget per camera signature with
its grow-and-redo guard. Where the JAX step rolls the model back after an
overflowing step, the port decides before the backward and the optimizer
step (the forward already returns live_total), so nothing is rolled back.
The port reports live_total for any top-k width; the JAX package reports it
(and clamps) only where its packed rows fit (L*topk <= 4), so at wider
codes the two keep different budgets with the same results.

Not ported yet, and raising NotImplementedError: camera batches
(`cam_batch > 1`), gradient accumulation (`accum_iter > 1`), the
pixel-space loss (l1 / normalize), the capped route (`tile_budget > 0`)
and the viewer (`gui_source_path`).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..models.gaussians import GaussianModel
from ..models.renderer import make_settings, render
from ..ops.gram import gram_loss_fused, seg_to_tiles
from ..ops.projection import BLOCK
from .optimizers import grouped_adam

FEATURE_PARAM_NAMES = ("language_logits", "codebooks")


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} belongs to a later slice of the port: {slice_name} "
        "(ROADMAP.md, Queue 1)")


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
                   gt_table):
    """The XLA formulation, differentiated by autograd: w [L, K, Q]
    coefficients in any pixel order, seg_flat [Q] (-1 = masked or
    padding), hw the pixel count the mean divides by. Layers below `lay`
    enter detached. The JAX one-hot matmul lookup is an exact row selection;
    here it is a gather."""
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
    return 1.0 - sim.sum() / hw


# ---------------------------------------------------------------- the step

def make_feature_train_step(settings, optimizer: torch.optim.Optimizer,
                            topk: int):
    """The feature step on the exact route with the cosine loss in Gram
    space: the map stays in tile layout and the fused Gram loss (K6a/K6b)
    reads it.

    Returns step(model, view, proj, campos, bg, gt_table, seg_map,
    layer_idx=0, accept=None, device=None) -> (metrics, applied). The
    forward runs first; when `accept(metrics)` says no, the step returns
    without a backward or an update (the trainer's redo). Otherwise the
    gradients of logits and codebooks are formed, the logits' zeroed on
    dead rows, and the optimizer steps; the gradients stay in `.grad`."""
    render_settings = settings._replace(assemble=False)

    def step(model, view, proj, campos, bg, gt_table, seg_map,
             layer_idx: int = 0, accept: Callable | None = None,
             device=None):
        out = render(render_settings, model, view, proj, campos, bg,
                     include_feature=True, topk=topk, device=device)
        loss = gram_loss_fused(model.codebooks,
                               out.language_feature_weight_map, gt_table,
                               seg_map, layer_idx)
        metrics = {"loss": loss.detach(), "live_total": out.live_total,
                   "total_entries": out.total_entries}
        if accept is not None and not accept(metrics):
            return metrics, False
        optimizer.zero_grad(set_to_none=False)
        loss.backward()
        # Dead (padding) rows must not drift.
        model.language_logits.grad.masked_fill_(~model.live[:, None], 0.0)
        optimizer.step()
        return metrics, True

    return step


# ---------------------------------------------------------------- the loop

@dataclass
class TrainLogs:
    losses: list = field(default_factory=list)
    ema_loss: float = 0.0
    live_budget: dict = field(default_factory=dict)   # camera sig -> budget


def camera_arrays(camera, bg):
    """(view, proj, campos, bg) as float32 numpy arrays."""
    return (np.asarray(camera.world_view_transform, np.float32),
            np.asarray(camera.full_proj_transform, np.float32),
            np.asarray(camera.camera_center, np.float32),
            np.asarray(bg, np.float32))


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
    max_entries: int = 2 ** 21,
    accum_iter: int = 1,
    cam_batch: int = 1,
    tile_budget: float = 0.0,
    optimizer: torch.optim.Optimizer | None = None,
    feature_cache: dict | None = None,
    on_iteration: Callable[[int, GaussianModel, Any, dict], None] | None
    = None,
    gui_source_path: str | None = None,
    device=None,
):
    """The feature phase's sequential loop (reference train.py language
    branch), the cosine-only Gram configuration. Returns (model, optimizer,
    logs); the model's logits and codebooks are updated in place.

    `feature_cache` maps camera.image_name -> GT tensors (pass {} to keep
    them across epochs); `on_iteration(iteration, model, optimizer,
    metrics)` runs after each step."""
    if cam_batch > 1:
        raise _later("cam_batch > 1", "camera-batched feature steps (item 7)")
    if accum_iter > 1:
        raise _later("accum_iter > 1", "gradient accumulation (item 7)")
    if use_l1_loss or normalize or not use_cos_loss:
        raise _later("the pixel-space loss (l1 / normalize)",
                     "pixel-space feature loss (item 7)")
    if tile_budget > 0.0:
        raise _later("tile_budget > 0",
                     "the capped training route, kernel K5 (item 7)")
    if gui_source_path is not None:
        raise _later("gui_source_path", "the viewer (item 9)")
    if model.language_logits is None or model.codebooks is None:
        raise ValueError("train_features needs language logits and "
                         "codebooks (init_language_features)")
    dev = resolve_device(device)
    if model.xyz.device.type != dev.type:
        raise ValueError(f"the model lies on {model.xyz.device}, not {dev}")
    if optimizer is None:
        optimizer = make_feature_optimizer(opt, model)
    rng = random.Random(seed)
    logs = TrainLogs()
    layer_num = model.codebooks.shape[0]
    # Live-prefix budget per camera signature: 0 = full budget (the first
    # step of a signature measures live_total); a later viewpoint whose
    # live_total overflows the budget grows it and redoes its step.
    live_budget = logs.live_budget

    def _grow_budget(lt: int) -> int:
        return min(max_entries, -(-int(lt * 1.3 + 32768) // 65536) * 65536)

    def cam_sig(camera):
        return (camera.image_height, camera.image_width,
                round(camera.tanfovx, 9), round(camera.tanfovy, 9))

    def get_step(camera, sig):
        settings = make_settings(camera, model.active_sh_degree, 1.0,
                                 max_entries,
                                 live_entries=live_budget.get(sig, 0))
        return make_feature_train_step(settings, optimizer, topk)

    def budget_check(sig):
        def accept(metrics) -> bool:
            lt = int(metrics["live_total"])
            cur = live_budget.get(sig, 0)
            if cur == 0:
                # The first step ran at the full budget (exact): tighten
                # for the rest of the run.
                live_budget[sig] = _grow_budget(lt)
                return True
            if lt <= cur:
                return True
            # The clamp would drop real entries: grow and redo.
            live_budget[sig] = _grow_budget(lt)
            return False
        return accept

    def curriculum_layer(it):
        return min(int(it / 10000 * layer_num), layer_num - 1)

    def get_gt(cam):
        if feature_cache is not None and cam.image_name in feature_cache:
            return feature_cache[cam.image_name]
        table, seg = cam.get_language_feature_compact(lf_dir, feature_level)
        # A coarse 512-row grid of table sizes (padded rows are never
        # selected by any segment id).
        s_pad = -(-max(table.shape[0], 1) // 512) * 512
        table = np.pad(table, ((0, s_pad - table.shape[0]), (0, 0)))
        pair = (torch.from_numpy(table).to(dev),
                torch.from_numpy(np.ascontiguousarray(seg)).to(dev))
        if feature_cache is not None:
            feature_cache[cam.image_name] = pair
        return pair

    viewpoint_stack: list = []
    for iteration in range(first_iter + 1, iterations + 1):
        if not viewpoint_stack:
            viewpoint_stack = list(cameras)
        cam = viewpoint_stack.pop(rng.randint(0, len(viewpoint_stack) - 1))
        layer_idx = curriculum_layer(iteration)
        sig = cam_sig(cam)
        view, proj, campos, bg = camera_arrays(cam, bg_color)
        gt_table, seg = get_gt(cam)
        applied = False
        while not applied:
            metrics, applied = get_step(cam, sig)(
                model, view, proj, campos, bg, gt_table, seg, layer_idx,
                accept=budget_check(sig), device=dev)
        loss = float(metrics["loss"])
        logs.ema_loss = 0.4 * loss + 0.6 * logs.ema_loss
        logs.losses.append(loss)
        if on_iteration is not None:
            on_iteration(iteration, model, optimizer, metrics)
    return model, optimizer, logs
