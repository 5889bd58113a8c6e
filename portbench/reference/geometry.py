"""Geometry training (LangSplatV2's Stage B, train.py:169-258, which runs
3D Gaussian Splatting unchanged: Kerbl et al., SIGGRAPH 2023, arXiv
2308.04079; graphdeco-inria/gaussian-splatting train.py,
gaussian_model.py:448-508, arguments/__init__.py OptimizationParams),
written from the published method in plain PyTorch: its first steps and
one densification round.

A step:
- activation: exp scales, unit quaternions, sigmoid opacities, SH
  coefficients [N, 16, 3] (render.activate);
- render.py's projection under autograd: SH colour at the configured
  degree, the EWA conic with the 0.3 dilation, the depth-0.2 cull;
- the depth-ordered tile entries and the front-to-back blend with its
  termination (render.entries, render.tile_groups), bg black;
- the loss (1 - lambda) L1 + lambda (1 - SSIM), SSIM over an 11 x 11
  Gaussian window of sigma 1.5 with zero padding (loss_utils.py);
- the gradients of the six leaves (xyz, features_dc, features_rest,
  scaling, rotation, opacity) and the means2D statistic, the norm of
  dL/d(screen xy) scaled by (W/2, H/2) (the rasterizer's NDC gradient);
- Adam (betas 0.9, 0.999, eps 1e-15) at 3DGS's rates, xyz on
  expon_lr_func times the spatial scale (general_utils.py:29-62).

It is computed in blocks so that it fits at 1M Gaussians: (1) the image
without gradient; (2) dL/dimage through the loss alone (SSIM couples
pixels); (3) one tile group at a time, the blend recomputed with gradient
and its VJP added into the screen state (xy, conic, opacity, colour);
(4) autograd through the projection once.

A round (densify_and_prune, gaussian_model.py:448-503) over given
statistics and split noise: clone where the mean statistic reaches the
threshold and the largest scale is at most percent_dense x extent, else
split into 2 samples from the Gaussian's own ellipsoid with scales over
0.8 x 2; then prune opacity < 0.005 and, with the size threshold on, a
world scale over 0.1 x extent.

Departures, each also the program's:
- a Gaussian is visible (it is drawn and its statistic counts) only where
  render.py's opacity-aware cull keeps it (opacity above 1/255), where the
  CUDA rasterizer's radii > 0 also keep such a Gaussian;
- the blend's gradient stops where alpha is clamped at 0.99 (autograd of
  the forward; the CUDA backward passes it through the clamp);
- the screen-radius prune is left out: densification_postfix resets
  max_radii2D to 0 before the prune reads it, so it never fires;
- the background is black: the final transmittance then carries no
  gradient.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import matmul, tf32_round
from .render import (activate, entries, image_to_tiles, project,
                     tile_groups, tiles_to_image)

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")
WINDOW, SIGMA = 11, 1.5
C1, C2 = 0.01 ** 2, 0.03 ** 2
BETAS, ADAM_EPS = (0.9, 0.999), 1e-15
MIN_OPACITY = 0.005


# ---------------------------------------------------------------- the loss

def _window(channels: int, device) -> torch.Tensor:
    x = torch.arange(WINDOW, dtype=torch.float32, device=device)
    g = torch.exp(-((x - WINDOW // 2) ** 2) / (2 * SIGMA ** 2))
    g = g / g.sum()
    return torch.outer(g, g)[None, None].expand(
        channels, 1, WINDOW, WINDOW).contiguous()


class _TF32Filter(torch.autograd.Function):
    """The depthwise window filter with TF32 operands (the control), its
    adjoint the same filter (the window is symmetric)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        return F.conv2d(tf32_round(x), tf32_round(w), padding=WINDOW // 2,
                        groups=x.shape[1])

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return F.conv2d(tf32_round(g), tf32_round(w), padding=WINDOW // 2,
                        groups=g.shape[1]), None


def _filter(x: torch.Tensor, prec: str) -> torch.Tensor:
    w = _window(x.shape[1], x.device)
    if prec == "tf32":
        return _TF32Filter.apply(x, w)
    if prec != "f32":
        raise ValueError(f"unknown precision {prec!r}")
    return F.conv2d(x, w, padding=WINDOW // 2, groups=x.shape[1])


def ssim(img1: torch.Tensor, img2: torch.Tensor, prec: str = "f32"):
    """Mean SSIM of two [C, H, W] images (loss_utils.py:41-71)."""
    c = img1.shape[0]
    mu1, mu2, e11, e22, e12 = _filter(torch.cat(
        [img1, img2, img1 * img1, img2 * img2, img1 * img2])[None],
        prec)[0].split(c)
    s11, s22, s12 = e11 - mu1 * mu1, e22 - mu2 * mu2, e12 - mu1 * mu2
    m = ((2 * mu1 * mu2 + C1) * (2 * s12 + C2)) / (
        (mu1 * mu1 + mu2 * mu2 + C1) * (s11 + s22 + C2))
    return m.mean()


def rgb_loss(img, gt, lambda_dssim: float, prec: str = "f32",
             fault: str | None = None):
    """(1 - lambda) L1 + lambda (1 - SSIM) of [3, H, W] images. fault
    "half_batch" takes both terms over the top half of the rows alone."""
    if fault == "half_batch":
        h = img.shape[1] // 2
        img, gt = img[:, :h], gt[:, :h]
    l1 = (img - gt).abs().mean()
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (
        1.0 - ssim(img, gt, prec))


# ---------------------------------------------------------------- a step

def _rgb_tiles(pr: dict, ent: dict, prec: str) -> torch.Tensor:
    """[T, 256, 3] blended colour (bg black), without gradient."""
    gx, gy = pr["grid"]
    out = torch.zeros((gx * gy, 256, 3), device=pr["xy"].device)
    for tiles, gid, mask, w, _ft, _c in tile_groups(pr, ent):
        out[tiles] = matmul(w, torch.where(mask[..., None], pr["rgb"][gid],
                                           0.0), prec)
    return out


def _blend_vjp(pr: dict, ent: dict, d_tiles: torch.Tensor,
               prec: str) -> dict:
    """The blend's VJP for d_tiles [T, 256, 3]: a tile group at a time,
    the group's blend recomputed with gradient in the screen state and
    its gradient added up. Returns d(xy, conic, op, rgb)."""
    leaves = {k: pr[k].detach().requires_grad_(True)
              for k in ("xy", "conic", "op", "rgb")}
    with torch.enable_grad():
        for tiles, gid, mask, w, _ft, _c in tile_groups(
                dict(pr, **leaves), ent):
            col = matmul(w, torch.where(mask[..., None], leaves["rgb"][gid],
                                        0.0), prec)
            col.backward(d_tiles[tiles])
    return {k: (torch.zeros_like(v) if v.grad is None else v.grad)
            for k, v in leaves.items()}


def step_grads(raw: dict, cam: dict, gt: torch.Tensor, cfg: dict,
               prec: str = "f32", fault: str | None = None) -> dict:
    """One step's loss and gradients at the raw fields `raw` (the six
    leaves, live Gaussians only) for the camera dict `cam` and its target
    [3, H, W]. Returns the loss, the gradient of each leaf, `means2d`
    [N, 2] (dL/d(screen xy) times (W/2, H/2)) and `visible` [N]."""
    W, H = cam["width"], cam["height"]
    leaves = {k: raw[k].detach().requires_grad_(True) for k in LEAVES}
    with torch.enable_grad():
        pr = project(activate(leaves), cam, cfg["sh_degree"])
    prd = {k: (v.detach() if torch.is_tensor(v) else v)
           for k, v in pr.items()}
    with torch.no_grad():
        ent = entries(prd)
        gx, gy = prd["grid"]
        img = tiles_to_image(_rgb_tiles(prd, ent, prec), gx, gy, H, W)
    img.requires_grad_(True)
    with torch.enable_grad():
        loss = rgb_loss(img, gt, cfg["lambda_dssim"], prec, fault)
        (d_img,) = torch.autograd.grad(loss, img)
    d_tiles = torch.stack([image_to_tiles(d_img[c], gx, gy)
                           for c in range(3)], -1)
    d = _blend_vjp(prd, ent, d_tiles, prec)
    with torch.enable_grad():
        torch.autograd.backward([pr["xy"], pr["conic"], pr["op"], pr["rgb"]],
                                [d["xy"], d["conic"], d["op"], d["rgb"]])
    scale = torch.tensor([0.5 * W, 0.5 * H], device=d["xy"].device)
    return dict(loss=float(loss.detach()),
                grads={k: leaves[k].grad for k in LEAVES},
                means2d=d["xy"] * scale, visible=prd["live"])


# ------------------------------------------------------------------- Adam

def expon_lr(step: int, lr_init: float, lr_final: float,
             max_steps: int) -> float:
    """general_utils.py get_expon_lr_func without a delay: the log-linear
    decay from lr_init to lr_final over max_steps."""
    if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
        return 0.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def rates(cfg: dict, extent: float, step: int) -> dict:
    """Each leaf's rate for Adam's step `step` (gaussian_model.py:244-257:
    xyz scheduled and scaled by the spatial scale, the rest constant)."""
    lr = cfg["lr"]
    return {"xyz": expon_lr(step, lr["position_init"] * extent,
                            lr["position_final"] * extent,
                            lr["position_max_steps"]),
            "features_dc": lr["feature"], "features_rest": lr["feature"] / 20,
            "opacity": lr["opacity"], "scaling": lr["scaling"],
            "rotation": lr["rotation"]}


def geometry_steps(raw0: dict, moments0: dict, step0: int, steps: list,
                   cfg: dict, extent: float, prec: str = "f32",
                   fault: str | None = None) -> dict:
    """len(steps) steps from the raw fields `raw0` (live Gaussians) with
    Adam's moments `moments0` {leaf: (m, v)} after `step0` updates. steps:
    dicts with `cam` and `gt`. Returns each step's loss, the first step's
    gradients (and its `means2d`), and each leaf's change after the last
    step. fault "unchanged": no update is applied."""
    params = {k: raw0[k].clone() for k in LEAVES}
    moments = {k: (m.clone(), v.clone()) for k, (m, v) in moments0.items()}
    b1, b2 = BETAS
    losses, first = [], None
    for i, st in enumerate(steps, 1):
        r = step_grads(params, st["cam"], st["gt"], cfg, prec, fault)
        losses.append(r["loss"])
        if first is None:
            first = dict(r["grads"], means2d=r["means2d"])
        if fault == "unchanged":
            continue
        t = step0 + i
        lr = rates(cfg, extent, t)
        with torch.no_grad():
            for k in LEAVES:
                m, v = moments[k]
                g = r["grads"][k]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(ADAM_EPS)
                params[k].addcdiv_(m, denom, value=-lr[k] / (1 - b1 ** t))
    return dict(losses=losses, first_grad=first,
                change={k: params[k] - raw0[k] for k in LEAVES})


# ------------------------------------------------------------------ a round

def _rotation(q: torch.Tensor) -> torch.Tensor:
    """build_rotation: unit quaternions (w, x, y, z) -> [N, 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def densify_round(fields: dict, grad_accum: torch.Tensor,
                  denom: torch.Tensor, eps: torch.Tensor, extent: float,
                  cfg: dict, size_threshold: bool) -> dict:
    """One densify-and-prune round over the live Gaussians' raw fields
    (the six leaves, [N, ...]) with their statistics (the summed means2D
    norms and the counts, [N]) and the split noise eps [2, N, 3] (copy
    n of Gaussian i draws eps[n, i]). Returns the fields of the Gaussians
    after the round, in no particular order."""
    with torch.no_grad():
        grads = grad_accum / denom
        grads = torch.where(torch.isnan(grads), 0.0, grads)
        scaling = torch.exp(fields["scaling"])
        max_scale = scaling.max(dim=1).values
        hot = grads >= cfg["densify_grad_threshold"]
        small = max_scale <= cfg["percent_dense"] * extent
        # densify_and_clone: copies appended after the originals.
        clone = hot & small
        out = {k: torch.cat([v, v[clone]]) for k, v in fields.items()}
        # densify_and_split: the originals only (a clone's statistic is 0),
        # each replaced by 2 samples.
        split = hot & ~small
        src = torch.nonzero(split)[:, 0]
        R = _rotation(fields["rotation"][src])
        kids = {k: [] for k in fields}
        for n in range(2):
            s = eps[n, src] * scaling[src]
            kids["xyz"].append(fields["xyz"][src]
                               + (R * s[:, None, :]).sum(-1))
            kids["scaling"].append(torch.log(scaling[src] / (0.8 * 2)))
            for k in ("rotation", "features_dc", "features_rest", "opacity"):
                kids[k].append(fields[k][src])
        keep = torch.cat([~split, torch.ones(int(clone.sum()),
                                             dtype=torch.bool,
                                             device=split.device)])
        out = {k: torch.cat([v[keep]] + kids[k]) for k, v in out.items()}
        # prune
        op = 1.0 / (1.0 + torch.exp(-out["opacity"][:, 0]))
        prune = op < MIN_OPACITY
        if size_threshold:
            prune |= torch.exp(out["scaling"]).max(dim=1).values \
                > 0.1 * extent
        return {k: v[~prune] for k, v in out.items()}
