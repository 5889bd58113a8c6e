"""The port's slice end to end against the JAX package: merged 3-level
quick render (3 x 64 x 512 codebooks, 12 pairs) + the tile-layout
relevancy query, the RGB-only render, and a JAX-written checkpoint.

JAX side: `render(..., quick_render=True)` with RasterizeSettings
impl="pallas", precision="f32", assemble=False (Pallas in interpret mode
on the CPU) and `OpenCLIPNetwork.get_max_across_from_weights` with the hash
backend. Port side: the same entry points with device="cpu" (every kernel
wrapper runs its plain version).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.eval.openclip import OpenCLIPNetwork as JaxClip
from langsplatv2_tpu.models.gaussians import GaussianModel as JaxModel
from langsplatv2_tpu.models.io import save_checkpoint
from langsplatv2_tpu.models.renderer import render as jax_render
from langsplatv2_tpu.ops import rasterize_tiles as jax_tiles
from langsplatv2_tpu.ops.rasterize import RasterizeSettings as JaxSettings
from langsplatv2_tpu_torch.eval.openclip import OpenCLIPNetwork
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.models.io import load_checkpoint
from langsplatv2_tpu_torch.models.renderer import render
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings
from langsplatv2_tpu_torch.ops.rasterize_tiles import tiles_to_image

from torch_port_fixtures import camera, model_fields

H, W = 96, 128
N = 1500
BG = np.asarray([0.2, 0.1, 0.4], np.float32)
PROMPTS = ["teddy bear"]
TOL = 1e-4


def _settings(cls, tfx, tfy):
    return cls(image_height=H, image_width=W, tanfovx=tfx, tanfovy=tfy,
               sh_degree=0, max_entries=2 ** 14, impl="pallas",
               precision="f32", assemble=False)


@pytest.fixture(scope="module")
def reference():
    """The JAX model, its quick render + relevancy and its RGB render."""
    fields = model_fields(N, seed=11)
    view, pm, tfx, tfy = camera(H, W)
    model = JaxModel(**{k: jnp.asarray(v) for k, v in fields.items()},
                     active_sh_degree=0, max_sh_degree=0)
    s = _settings(JaxSettings, tfx, tfy)
    args = (s, model, jnp.asarray(view), jnp.asarray(pm),
            jnp.zeros(3, jnp.float32), jnp.asarray(BG))
    quick = jax_render(*args, quick_render=True)
    rgb_only = jax_render(*args)
    clip = JaxClip(backend="hash")
    clip.set_positives(PROMPTS)
    wmap = jax_tiles.tiles_to_image(quick.language_feature_weight_map,
                                    s.grid_x, s.grid_y, H, W)
    relev = clip.get_max_across_from_weights(wmap, model.codebooks)
    return dict(fields=fields, model=model, view=view, pm=pm, tfx=tfx,
                tfy=tfy, quick=quick, rgb_only=rgb_only,
                relev=np.asarray(relev))


def _port_quick(ref, model):
    s = _settings(RasterizeSettings, ref["tfx"], ref["tfy"])
    out = render(s, model, ref["view"], ref["pm"], np.zeros(3, np.float32),
                 BG, quick_render=True, device="cpu")
    clip = OpenCLIPNetwork("hash", device="cpu")
    clip.set_positives(PROMPTS)
    phi, gram = clip.prompt_constants(model.codebooks)
    relev = clip.relevancy_from_tiles(out.language_feature_weight_map, phi,
                                      gram, s.grid_x, s.grid_y, H, W)
    return out, relev


def _check_quick(ref, out, relev):
    q = ref["quick"]
    assert int(out.total_entries) == int(q.total_entries)
    assert int(out.live_total) == int(q.live_total)
    assert int(out.max_tile_count) == int(q.max_tile_count)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(q.radii))
    wm = out.language_feature_weight_map
    assert wm.shape == (math.ceil(H / 16) * math.ceil(W / 16), 256, 192)
    np.testing.assert_allclose(wm.numpy(),
                               np.asarray(q.language_feature_weight_map),
                               atol=TOL)
    np.testing.assert_allclose(out.render.numpy(), np.asarray(q.render),
                               atol=TOL)
    np.testing.assert_allclose(out.final_transmittance.numpy(),
                               np.asarray(q.final_transmittance), atol=TOL)
    assert relev.shape == (3, len(PROMPTS), H, W)
    np.testing.assert_allclose(relev.numpy(), ref["relev"], atol=TOL)
    # The scene covers the frame: the comparison is not of empty maps.
    assert float((out.final_transmittance < 0.5).float().mean()) > 0.5


def test_quick_render_and_relevancy_match_jax(reference):
    model = from_numpy_params(reference["fields"], device="cpu")
    _check_quick(reference, *_port_quick(reference, model))


def test_jax_checkpoint_loads_and_renders(reference, tmp_path):
    path = str(tmp_path / "chkpnt7.npz")
    save_checkpoint(path, reference["model"], None, 7)
    model, iteration = load_checkpoint(path, device="cpu")
    assert iteration == 7
    _check_quick(reference, *_port_quick(reference, model))


def test_rgb_render_matches_jax(reference):
    model = from_numpy_params(reference["fields"], device="cpu")
    s = _settings(RasterizeSettings, reference["tfx"], reference["tfy"])
    out = render(s, model, reference["view"], reference["pm"],
                 np.zeros(3, np.float32), BG, device="cpu")
    ref = reference["rgb_only"]
    assert out.language_feature_weight_map is None
    assert int(out.total_entries) == int(ref.total_entries)
    np.testing.assert_allclose(out.render.numpy(), np.asarray(ref.render),
                               atol=TOL)
    np.testing.assert_allclose(out.final_transmittance.numpy(),
                               np.asarray(ref.final_transmittance), atol=TOL)


def test_relevancy_from_assembled_map_matches_jax(reference):
    """get_max_across_from_weights ([L*K, H, W] in) on the JAX map, and the
    tile-layout K3 route on the same map, against the JAX relevancy."""
    model = from_numpy_params(reference["fields"], device="cpu")
    s = _settings(RasterizeSettings, reference["tfx"], reference["tfy"])
    tiles = torch.from_numpy(np.array(
        reference["quick"].language_feature_weight_map))
    clip = OpenCLIPNetwork("hash", device="cpu")
    clip.set_positives(PROMPTS)
    wmap = tiles_to_image(tiles, s.grid_x, s.grid_y, H, W)
    out = clip.get_max_across_from_weights(wmap, model.codebooks)
    np.testing.assert_allclose(out.numpy(), reference["relev"], atol=1e-5)
    phi, gram = clip.prompt_constants(model.codebooks)
    via_tiles = clip.relevancy_from_tiles(tiles, phi, gram, s.grid_x,
                                          s.grid_y, H, W)
    np.testing.assert_allclose(via_tiles.numpy(), out.numpy(), atol=1e-5)
