"""The port's pixel-space feature loss (--l1_loss / --normalize) against the
JAX package: the loss of trainer.py:408-421 (the assembled map decoded by
compute_layer_feature_map, optionally normalized, cos_loss / l1_loss under
the mask of the dense GT) on the quick-train route, exact (K4) and capped
(K5), its value and the gradients of logits and codebooks; and
tests/test_training.py::test_gram_step_matches_pixel_step on the port.

JAX side: impl="pallas" (its kernels in interpret mode on the CPU). Port
side: device="cpu" (every kernel wrapper runs its plain version).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.models.gaussians import GaussianModel as JaxModel
from langsplatv2_tpu.models.renderer import render as jax_render
from langsplatv2_tpu.ops.rasterize import RasterizeSettings as JaxSettings
from langsplatv2_tpu.utils import losses as jax_losses
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.models.renderer import render
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings
from langsplatv2_tpu_torch.train import trainer

from torch_port_fixtures import camera

H, W, K, TOPK = 48, 64, 16, 4
NAMES = ("language_logits", "codebooks")


def covered_scene(levels: int, seed: int = 0):
    """40 random Gaussians before a 14 x 10 backdrop of wide opaque ones at
    depth 9, so that every pixel has a non-zero feature (JAX's normalize
    takes the norm's gradient, NaN at a zero vector); one-hot GT of 5
    segments with 10% of the pixels masked."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(-7, 7, 14), np.linspace(-5, 5, 10))
    back = np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, 9.0)], 1)
    front = np.concatenate([rng.uniform(-2, 2, (40, 2)),
                            rng.uniform(2.0, 6.0, (40, 1))], 1)
    xyz = np.concatenate([front, back]).astype(np.float32)
    n = xyz.shape[0]
    scales = np.concatenate([rng.uniform(0.1, 0.4, (40, 3)),
                             np.full((gx.size, 3), 0.9)])
    rot = np.zeros((n, 4), np.float32)
    rot[:, 0] = 1.0
    fields = dict(
        xyz=xyz, features_dc=np.zeros((n, 1, 3), np.float32),
        features_rest=np.zeros((n, 0, 3), np.float32),
        scaling=np.log(scales).astype(np.float32), rotation=rot,
        opacity=np.full((n, 1), 1.5, np.float32), live=np.ones(n, bool),
        language_logits=rng.normal(size=(n, levels * K)).astype(np.float32),
        codebooks=rng.normal(size=(levels, K, 512)).astype(np.float32))
    table = rng.normal(size=(5, 512)).astype(np.float32)
    seg = rng.integers(0, 5, (H, W)).astype(np.int32)
    seg[rng.uniform(size=(H, W)) < 0.1] = -1
    gt = (np.where(seg >= 0, 1, 0)[None]
          * np.transpose(table[np.clip(seg, 0, None)], (2, 0, 1))).astype(
              np.float32)
    return fields, table, seg, gt, (seg >= 0)[None]


def port_loss_and_grads(fields, settings, gt, mask, layer, cos, l1, norm,
                        space="pixel", table=None, seg=None):
    model = from_numpy_params(fields, active_sh_degree=0, max_sh_degree=0,
                              device="cpu")
    trainer.feature_params(model)
    view, pm, _, _ = camera(H, W)
    s = settings._replace(assemble=space == "pixel")
    out = render(s, model, view, pm, np.zeros(3, np.float32),
                 np.zeros(3, np.float32), include_feature=True, topk=TOPK,
                 device="cpu")
    if space == "pixel":
        loss, _ = trainer.pixel_loss(
            model, out.language_feature_weight_map, torch.from_numpy(gt),
            torch.from_numpy(mask), layer, cos, l1, norm)
    else:
        loss = trainer.gram_loss_fused(
            model.codebooks, out.language_feature_weight_map,
            torch.from_numpy(table), torch.from_numpy(seg), layer)
    loss.backward()
    return (float(loss.detach()), {k: getattr(model, k).grad.numpy()
                                   for k in NAMES},
            out.language_feature_weight_map.detach())


def jax_loss_and_grads(fields, settings, gt, mask, layer, cos, l1, norm):
    """trainer.py:408-421 under jax.value_and_grad."""
    jm = JaxModel(**{k: jnp.asarray(v) for k, v in fields.items()},
                  active_sh_degree=0, max_sh_degree=0)
    view, pm, _, _ = camera(H, W)

    def loss_fn(params):
        m = jm.replace(**params)
        out = jax_render(settings, m, jnp.asarray(view), jnp.asarray(pm),
                         jnp.zeros(3), jnp.zeros(3), include_feature=True,
                         topk=TOPK)
        feat = m.compute_layer_feature_map(out.language_feature_weight_map,
                                           layer)
        if norm:
            feat = feat / (jnp.linalg.norm(feat, axis=0, keepdims=True)
                           + 1e-10)
        msk = jnp.asarray(mask).astype(feat.dtype)
        loss = 0.0
        if cos:
            loss = loss + jax_losses.cos_loss(feat * msk, jnp.asarray(gt) * msk)
        if l1:
            loss = loss + jax_losses.l1_loss(feat * msk, jnp.asarray(gt) * msk)
        return loss

    v, g = jax.value_and_grad(loss_fn)({k: getattr(jm, k) for k in NAMES})
    return float(v), {k: np.asarray(x) for k, x in g.items()}


@pytest.mark.parametrize("levels,layer,cos,l1,norm,budget", [
    (1, 0, True, False, False, 0.0),
    (1, 0, True, True, False, 0.0),
    (2, 1, False, True, True, 0.0),
    (1, 0, True, True, True, 1e-6)],
    ids=["cos", "cos-l1", "l1-normalize-layer1", "capped-cos-l1-normalize"])
def test_pixel_loss_matches_jax(levels, layer, cos, l1, norm, budget):
    """Value at rtol 1e-5, gradients of logits and codebooks
    scale-normalized at 1e-5 (test_torch_port_train.py's step
    tolerance); the layer-1 case enters layer 0 detached."""
    fields, _, _, gt, mask = covered_scene(levels)
    tfx, tfy = camera(H, W)[2:]
    common = dict(max_entries=2 ** 14, tile_budget=budget,
                  tile_budget_cap=128)
    v, g, wmap = port_loss_and_grads(
        fields, RasterizeSettings(H, W, tfx, tfy, 0, **common), gt, mask,
        layer, cos, l1, norm)
    assert bool((wmap.reshape(levels * K, -1).abs().sum(0) > 0).all()), \
        "an uncovered pixel"
    rv, rg = jax_loss_and_grads(
        fields, JaxSettings(H, W, tfx, tfy, 0, impl="pallas", **common), gt,
        mask, layer, cos, l1, norm)
    np.testing.assert_allclose(v, rv, rtol=1e-5)
    for k in NAMES:
        scale = float(np.abs(rg[k]).max())
        assert scale > 0 and np.isfinite(rg[k]).all(), k
        np.testing.assert_allclose(g[k] / scale, rg[k] / scale, atol=1e-5,
                                   err_msg=k)
    if layer:
        assert not rg["codebooks"][0].any() and not g["codebooks"][0].any()


def test_gram_step_matches_pixel_step():
    """tests/test_training.py::test_gram_step_matches_pixel_step on the
    port: the fused Gram loss on the compact GT and the pixel-space cosine
    loss on the dense GT give the same value (rtol 1e-5) and gradients
    (atol 2e-6); with every Gaussian transparent the Gram step's
    gradients stay finite."""
    fields, table, seg, gt, mask = covered_scene(1, seed=1)
    tfx, tfy = camera(H, W)[2:]
    s = RasterizeSettings(H, W, tfx, tfy, 0, max_entries=2 ** 14)
    v_p, g_p, _ = port_loss_and_grads(fields, s, gt, mask, 0, True, False,
                                      False)
    v_g, g_g, _ = port_loss_and_grads(fields, s, gt, mask, 0, True, False,
                                      False, "gram", table, seg)
    np.testing.assert_allclose(v_g, v_p, rtol=1e-5)
    for k in NAMES:
        np.testing.assert_allclose(g_g[k], g_p[k], atol=2e-6, err_msg=k)
    dead = dict(fields, opacity=np.full_like(fields["opacity"], -12.0))
    vd, gd, _ = port_loss_and_grads(dead, s, gt, mask, 0, True, False, False,
                                    "gram", table, seg)
    assert np.isfinite(vd)
    for k, g in gd.items():
        assert np.isfinite(g).all(), k
