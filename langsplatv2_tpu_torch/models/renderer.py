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
runs the top-k forward and backward once for all its cameras.

The viewer's options, with JAX's precedence: `compute_cov3d_python` hands
the rasterizer the model's covariances at `settings.scale_modifier`
(`cov3d_precomp`, which the preprocess then takes as they are, so the
modifier is applied once; under impl="auto" such an RGB frame, and a
feature-mode frame, takes the rasterizer's XLA route, as in JAX);
`override_color` [N, 3] replaces the colours, else `convert_shs_python`
evaluates the SH colours here (`ops/projection.py::sh_to_color` at the
model's active degree) instead of in the preprocess. `render_camera`
renders a camera object.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tracing
from ..device import resolve_device
from ..ops.projection import sh_to_color
from ..ops.rasterize import RasterizeSettings, rasterize, to_f32
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
                  max_entries: int = 2 ** 21, tile_cap: int = 1024,
                  tile_batch: int = 16, impl: str = "auto",
                  live_entries: int = 0, tile_budget: float = 0.0,
                  tile_budget_cap: int = 128, tile_budget_subdiv: int = 2,
                  cull_alpha: float = 1.0 / 255.0) -> RasterizeSettings:
    """`camera` has image_height, image_width, tanfovx and tanfovy. The
    arguments are JAX's, in its order (models/renderer.py:40-70).
    tile_cap bounds the entries a tile blends on the XLA route and clamps
    the capped routes' kept counts; tile_batch is the XLA route's tiles a
    batch."""
    return RasterizeSettings(
        image_height=int(camera.image_height),
        image_width=int(camera.image_width),
        tanfovx=float(camera.tanfovx), tanfovy=float(camera.tanfovy),
        sh_degree=sh_degree, scale_modifier=scaling_modifier,
        max_entries=max_entries, tile_cap=tile_cap, tile_batch=tile_batch,
        impl=impl, live_entries=live_entries, tile_budget=tile_budget,
        tile_budget_cap=tile_budget_cap,
        tile_budget_subdiv=tile_budget_subdiv, cull_alpha=cull_alpha)


def render(settings: RasterizeSettings, model: GaussianModel, viewmatrix,
           projmatrix, campos, bg_color, *, include_feature: bool = False,
           quick_render: bool = False, topk: int = 4, override_color=None,
           convert_shs_python: bool = False,
           compute_cov3d_python: bool = False, means2d_dummy=None,
           precomputed_quick: tuple | None = None, device=None,
           stage_events: list | None = None) -> RenderOutput:
    """One frame of `model` from the camera, in the span "render" (every
    layer's span, tracing.py, opens under it)."""
    with tracing.span("render"):
        dev = resolve_device(device)
        scales = rotations = cov3d = None
        if compute_cov3d_python:
            cov3d = model.get_covariance(settings.scale_modifier)
        else:
            scales, rotations = model.get_scaling(), model.get_rotation()
        shs = colors = None
        if override_color is not None:
            colors = override_color
        elif convert_shs_python:
            colors = sh_to_color(model.get_features(), model.xyz,
                                 to_f32(campos, dev), model.active_sh_degree)
        else:
            # Read in place by the preprocess kernel (no concatenation).
            shs = (model.features_dc, model.features_rest)
        quick_weights = quick_indices = None
        quick_channels = 0
        quick_train = False
        if quick_render:
            if model.quick_weights is None or model.quick_indices is None:
                raise ValueError("quick_render needs a merged model's "
                                 "quick_weights and quick_indices")
            quick_weights = model.quick_weights
            quick_indices = model.quick_indices
            quick_channels = (model.codebooks.shape[0]
                              * model.codebooks.shape[1])
        elif include_feature:
            quick_weights, quick_indices = (
                model.get_weights_and_indices(topk)
                if precomputed_quick is None else precomputed_quick)
            quick_channels = (model.codebooks.shape[0]
                              * model.codebooks.shape[1])
            quick_train = True

        out = rasterize(
            settings, model.xyz, model.get_opacity(), viewmatrix, projmatrix,
            campos, bg_color, scales=scales, rotations=rotations,
            cov3d_precomp=cov3d, shs=shs, colors_precomp=colors,
            quick_weights=quick_weights,
            quick_indices=quick_indices, quick_channels=quick_channels,
            quick_train=quick_train, means2d_dummy=means2d_dummy, device=dev,
            stage_events=stage_events)
        return RenderOutput(
            render=out.rgb, language_feature_weight_map=out.feature_map,
            visibility_filter=out.radii > 0, radii=out.radii,
            final_transmittance=out.final_transmittance,
            max_tile_count=out.max_tile_count,
            total_entries=out.total_entries, live_total=out.live_total)


def render_camera(camera, model: GaussianModel, bg_color, *,
                  scaling_modifier: float = 1.0, max_entries: int = 2 ** 21,
                  **kwargs) -> RenderOutput:
    """`render` of a camera object (image size, tangents and its
    transposed matrices and centre); the rest of the keywords go to
    `render`."""
    settings = make_settings(camera, model.active_sh_degree,
                             scaling_modifier, max_entries)
    return render(settings, model, camera.world_view_transform,
                  camera.full_proj_transform, camera.camera_center,
                  bg_color, **kwargs)
