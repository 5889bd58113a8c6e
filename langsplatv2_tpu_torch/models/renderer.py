"""Render facade: camera + GaussianModel -> images and maps
(port of langsplatv2_tpu/models/renderer.py).

Three modes: `quick_render=True` (the merged model's 192-channel
coefficient map), `include_feature=True` (feature-phase training: the
model's top-k (weight, index) pairs from its logits, blended to an
L*K-channel map that is differentiable in the weights), and RGB only, with
SH colours: the geometry phase's mode, differentiable in the model's six
RGB fields and in the `means2d_dummy` carrier (the JAX package's stand-in
for torch's retain_grad on the screen-space means). `precomputed_quick`
hands the training mode its (weight, index) pairs, so that a camera batch
runs the top-k forward and backward once for all its cameras. The
Python-side covariance belongs to a later slice and raises; override
colours and Python-side SH are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from ..ops.rasterize import RasterizeSettings, rasterize
from .gaussians import GaussianModel


class RenderOutput(NamedTuple):
    render: torch.Tensor                        # [3, H, W]
    language_feature_weight_map: torch.Tensor | None  # [C, H, W] | [T, 256, C]
    visibility_filter: torch.Tensor             # [N] bool
    radii: torch.Tensor                         # [N] int32
    final_transmittance: torch.Tensor           # [H, W]
    max_tile_count: torch.Tensor                # []
    total_entries: torch.Tensor                 # []
    live_total: torch.Tensor | None = None      # []


def make_settings(camera, sh_degree: int, scaling_modifier: float = 1.0,
                  max_entries: int = 2 ** 21, impl: str = "auto",
                  live_entries: int = 0, tile_budget: float = 0.0,
                  tile_budget_cap: int = 128, tile_budget_subdiv: int = 2,
                  cull_alpha: float = 1.0 / 255.0) -> RasterizeSettings:
    """`camera` has image_height, image_width, tanfovx and tanfovy. The
    JAX options tile_cap and tile_batch (read by the reference rasterizer,
    a later slice) are left at their defaults."""
    return RasterizeSettings(
        image_height=int(camera.image_height),
        image_width=int(camera.image_width),
        tanfovx=float(camera.tanfovx), tanfovy=float(camera.tanfovy),
        sh_degree=sh_degree, scale_modifier=scaling_modifier,
        max_entries=max_entries, impl=impl, live_entries=live_entries,
        tile_budget=tile_budget, tile_budget_cap=tile_budget_cap,
        tile_budget_subdiv=tile_budget_subdiv, cull_alpha=cull_alpha)


def render(settings: RasterizeSettings, model: GaussianModel, viewmatrix,
           projmatrix, campos, bg_color, *, include_feature: bool = False,
           quick_render: bool = False, topk: int = 4,
           compute_cov3d_python: bool = False, means2d_dummy=None,
           precomputed_quick: tuple | None = None, device=None,
           stage_events: list | None = None) -> RenderOutput:
    if compute_cov3d_python:
        raise NotImplementedError(
            "compute_cov3d_python belongs to a later slice of the port: the "
            "differentiable reference rasterizer (ROADMAP.md, Queue 1 item 4)")
    dev = resolve_device(device)
    quick_weights = quick_indices = None
    quick_channels = 0
    quick_train = False
    if quick_render:
        if model.quick_weights is None or model.quick_indices is None:
            raise ValueError("quick_render needs a merged model's "
                             "quick_weights and quick_indices")
        quick_weights, quick_indices = model.quick_weights, model.quick_indices
        quick_channels = model.codebooks.shape[0] * model.codebooks.shape[1]
    elif include_feature:
        quick_weights, quick_indices = (
            model.get_weights_and_indices(topk) if precomputed_quick is None
            else precomputed_quick)
        quick_channels = model.codebooks.shape[0] * model.codebooks.shape[1]
        quick_train = True

    out = rasterize(
        settings, model.xyz, model.get_opacity(), viewmatrix, projmatrix,
        campos, bg_color, scales=model.get_scaling(),
        rotations=model.get_rotation(), shs=model.get_features(),
        quick_weights=quick_weights,
        quick_indices=quick_indices, quick_channels=quick_channels,
        quick_train=quick_train, means2d_dummy=means2d_dummy, device=dev,
        stage_events=stage_events)
    return RenderOutput(
        render=out.rgb, language_feature_weight_map=out.feature_map,
        visibility_filter=out.radii > 0, radii=out.radii,
        final_transmittance=out.final_transmittance,
        max_tile_count=out.max_tile_count, total_entries=out.total_entries,
        live_total=out.live_total)
