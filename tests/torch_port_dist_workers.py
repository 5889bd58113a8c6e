"""Rank functions for the port's multi-process tests (not collected).

`parallel.spawn_ranks` starts each rank with the spawn start method, which
imports this module afresh in the child: it imports torch, numpy and the
port, never JAX. Inputs arrive as numpy arrays and results go back as
numpy arrays, one dict a rank.
"""
from __future__ import annotations

import torch

from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings, rasterize
from langsplatv2_tpu_torch.parallel import (make_device_mesh,
                                            make_gauss_mesh,
                                            make_sharded_feature_train_step,
                                            make_sharded_rgb_train_step,
                                            rasterize_gauss_sharded,
                                            rasterize_sharded,
                                            save_checkpoint_multihost)
from langsplatv2_tpu_torch.parallel import sharding as sh
from langsplatv2_tpu_torch.parallel.gauss_sharded import \
    rasterize_gauss_sharded_feature_train
from langsplatv2_tpu_torch.train import trainer
from langsplatv2_tpu_torch.train.optimizers import grouped_adam


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _rows(case: dict, rank: int, world: int) -> dict:
    """The rank's rows of every per-Gaussian input of a case."""
    n = case["means3d"].shape[0]
    if n % world:
        raise ValueError(f"{n} Gaussians do not split over {world} ranks")
    sl = slice(rank * (n // world), (rank + 1) * (n // world))
    per = ("means3d", "opacities", "scales", "rotations", "colors_precomp",
           "shs", "quick_weights", "quick_indices")
    return {k: (v[sl] if k in per and v is not None else v)
            for k, v in case.items()}


def _gauss_forward(case: dict, mesh, rank: int, world: int) -> dict:
    c = _rows(case, rank, world)
    s = RasterizeSettings(**c["settings"])
    common = dict(scales=c["scales"], rotations=c["rotations"],
                  colors_precomp=c.get("colors_precomp"), shs=c.get("shs"))
    if c.get("facade"):
        out = rasterize(s, c["means3d"], c["opacities"], c["view"],
                        c["proj"], c["campos"], c["bg"], mesh=mesh,
                        quick_weights=c.get("quick_weights"),
                        quick_indices=c.get("quick_indices"),
                        quick_channels=c.get("quick_channels", 192),
                        device=mesh.device, **common)
        return dict(rgb=_np(out.rgb), feat=_np(out.feature_map),
                    t=_np(out.final_transmittance),
                    total=int(out.total_entries),
                    dropped=int(out.dropped_entries), radii=_np(out.radii),
                    max_tile_count=int(out.max_tile_count))
    stats = {}
    rgb, feat, t, total, dropped, radii = rasterize_gauss_sharded(
        mesh, s, c["means3d"], c["opacities"], c["view"], c["proj"],
        c["campos"], c["bg"], quick_weights=c.get("quick_weights"),
        quick_indices=c.get("quick_indices"),
        quick_channels=c.get("quick_channels", 192),
        pair_capacity=c.get("pair_capacity"), stats=stats, **common)
    return dict(rgb=_np(rgb), feat=_np(feat), t=_np(t), total=int(total),
                dropped=int(dropped), radii=_np(radii),
                dcount=_np(stats["dcount"]), cap=stats["cap"],
                received=int(stats["received"]))


def _gauss_grad(case: dict, mesh, rank: int, world: int) -> dict:
    """d(quick_weights) of sum(feat * probe) for the rank's rows."""
    c = _rows(case, rank, world)
    s = RasterizeSettings(**c["settings"])
    qw = torch.tensor(c["quick_weights"], requires_grad=True)
    stats = {}
    _rgb, feat_t, _t, total, dropped = rasterize_gauss_sharded_feature_train(
        mesh, s, c["means3d"], c["opacities"], c["view"], c["proj"],
        c["campos"], c["bg"], qw, c["quick_indices"], c["quick_channels"],
        scales=c["scales"], rotations=c["rotations"],
        colors_precomp=c["colors_precomp"],
        pair_capacity=c.get("pair_capacity"), stats=stats)
    probe = sh._image_to_tiles(torch.from_numpy(c["probe"]), s.grid_x,
                               s.grid_y)
    t0, strip = stats["tile_base"], stats["strip"]
    pad = torch.zeros((strip * world - probe.shape[0],) + probe.shape[1:])
    loss = (feat_t * torch.cat([probe, pad])[t0:t0 + strip]).sum()
    loss.backward()
    return dict(loss=float(loss.detach()), grad=_np(qw.grad), total=int(total),
                dropped=int(dropped))


def gauss_world(rank: int, world: int, cases: dict) -> dict:
    """Every Gaussian-sharded case on a "gauss" mesh of the world."""
    torch.set_num_threads(1)
    mesh = make_gauss_mesh(device="cpu")
    return {name: (_gauss_grad if "probe" in case else _gauss_forward)(
        case, mesh, rank, world) for name, case in cases.items()}


# ------------------------------------------------------------ tile-sharded

def _local_cams(cams: dict, mesh) -> dict:
    """The rank's B / n_data rows of each per-camera array."""
    n_data, d = mesh.shape["data"], mesh.coords["data"]
    b = cams["views"].shape[0] // n_data
    return {k: v[d * b:(d + 1) * b] for k, v in cams.items()}


def _render_case(case: dict, mesh_shape) -> dict:
    mesh = make_device_mesh(*mesh_shape, device="cpu")
    s = RasterizeSettings(**case["settings"])
    rgb, feat, radii, final_t = rasterize_sharded(
        mesh, s, case["means3d"], case["opacities"], case["view"],
        case["proj"], case["campos"], case["bg"], scales=case["scales"],
        rotations=case["rotations"], shs=case["shs"],
        features=case.get("features"),
        quick_weights=case.get("quick_weights"),
        quick_indices=case.get("quick_indices"),
        quick_channels=case.get("quick_channels", 192))
    return dict(rgb=_np(rgb), feat=_np(feat), radii=_np(radii),
                t=_np(final_t))


def _grads(params: dict) -> dict:
    return {k: _np(p.grad) for k, p in params.items()}


def _feature_loss(case: dict, mesh) -> dict:
    """The pixel- or Gram-space loss and its gradients, summed over the
    mesh, and one step's loss."""
    s = RasterizeSettings(**case["settings"])
    model = from_numpy_params(case["model"], device="cpu")
    cams = _local_cams(case["cams"], mesh)
    args = (cams["views"], cams["projs"], cams["camposs"], case["bg"],
            cams["gt_a"], cams["gt_b"])
    build = (sh.make_sharded_gram_loss(mesh, s, case["topk"])
             if case["space"] == "gram" else
             sh.make_sharded_feature_loss(mesh, s, case["topk"]))
    params = trainer.feature_params(model)
    partial, loss = build(model, *args)
    partial.backward()
    sh.reduce_gradients(params.values(), mesh)
    out = dict(loss=float(loss), grads=_grads(params))
    opt = grouped_adam({k: (p, 0.01) for k, p in params.items()})
    step = make_sharded_feature_train_step(mesh, s, opt, case["topk"],
                                           loss_space=case["space"])
    out["step_loss"] = float(step(model, *args)["loss"])
    return out


def _rgb_loss(case: dict, mesh) -> dict:
    """The RGB loss, its gradients and the carrier's, summed over the mesh;
    then one step from a fresh model and its densification statistics."""
    s = RasterizeSettings(**case["settings"])
    model = from_numpy_params(case["model"], device="cpu")
    cams = _local_cams(case["cams"], mesh)
    args = (cams["views"], cams["projs"], cams["camposs"], case["bg"],
            cams["gts"])
    params = trainer.rgb_params(model)
    dummy = torch.zeros((model.capacity, 2), requires_grad=True)
    build = sh.make_sharded_rgb_loss(mesh, s, case["lambda_dssim"])
    partial, loss, l1, radii = build(model, dummy, *args)
    partial.backward()
    sh.reduce_gradients([*params.values(), dummy], mesh)
    out = dict(loss=float(loss), l1=float(l1), radii=_np(radii),
               grads=_grads(params), dummy=_np(dummy.grad))
    model = from_numpy_params(case["model"], device="cpu")
    opt = trainer.make_rgb_optimizer(case["opt"], model)
    step = make_sharded_rgb_train_step(mesh, s, opt, case["lambda_dssim"])
    xyz0 = model.xyz.detach().clone()
    met = step(model, *args)
    out.update(step_loss=float(met["loss"]),
               num_visible=int(met["num_visible"]),
               xyz_moved=float((model.xyz.detach() - xyz0).abs().max()),
               xyz_gradient_accum=_np(model.xyz_gradient_accum),
               denom=_np(model.denom), max_radii2d=_np(model.max_radii2d))
    return out


def dist_world(rank: int, world: int, cases: dict, ckpt: str) -> dict:
    """The tile-sharded renders on (1, 4) and (2, 2), the feature and RGB
    losses and steps on (2, 2), and a multi-process checkpoint."""
    torch.set_num_threads(1)
    out = {f"render_{a}x{b}": _render_case(cases["render"], (a, b))
           for a, b in ((1, 4), (2, 2))}
    mesh = make_device_mesh(2, 2, device="cpu")
    out["pixel"] = _feature_loss(cases["pixel"], mesh)
    out["gram"] = _feature_loss(cases["gram"], mesh)
    out["rgb"] = _rgb_loss(cases["rgb"], mesh)
    model = from_numpy_params(cases["pixel"]["model"], device="cpu")
    save_checkpoint_multihost(ckpt, model, None, 7, extra={"rank": rank})
    return out
