"""Dense features (K2's dense mode, the dense custom VJP) against the JAX
package: `blend_tiles_pallas(mode="dense")` in interpret mode,
`rasterize(features=...)` with impl="pallas" (`rasterize_dense_vjp`) and
the XLA autodiff of impl="xla", impl="auto" (the XLA route in both
packages, geometry gradients included), and `get_render_weights`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.models.gaussians import GaussianModel as JaxModel
from langsplatv2_tpu.ops import pallas_blend
from langsplatv2_tpu.ops.rasterize import RasterizeSettings as JaxSettings
from langsplatv2_tpu.ops.rasterize import rasterize as jax_rasterize
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.ops import blend, projection
from langsplatv2_tpu_torch.ops.rasterize import (RasterizeSettings,
                                                 rasterize, sorted_binning)

from torch_port_fixtures import camera, model_fields, scene

N, H, W = 300, 48, 64


def _case(seed=0):
    sc = scene(N, seed)
    view, pm, tfx, tfy = camera(H, W)
    return sc, view, pm, tfx, tfy


@pytest.mark.parametrize("d", [64, 256])
def test_dense_blend_matches_pallas_kernel(d):
    """K2 dense's plain version against the Pallas kernel on the same
    segments (TestPallasBlend::test_dense_mode's check, atol 3e-5)."""
    sc, view, pm, tfx, tfy = _case(1)
    s = RasterizeSettings(H, W, tfx, tfy, 0, max_entries=2 ** 13)
    T = torch.from_numpy
    op = T(sc["opacities"][:, 0])
    proj = projection.preprocess(
        T(sc["means"]), T(sc["scales"]), T(sc["rotations"]), None,
        T(sc["colors"]), T(view), T(pm), torch.zeros(3), tfx, tfy, W, H, 0,
        opacities=op)
    g, start, count, _, _ = sorted_binning(s, proj, op)
    feats = np.random.default_rng(4).uniform(0, 1, (N, d)).astype(np.float32)
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, op, proj.rgb)
    rgb, feat, t = blend.blend_tiles_dense(g, start, count, geom, T(feats),
                                           T(bg), s.grid_x, s.grid_y)
    rows = pallas_blend.pack_gaussian_rows(
        jnp.asarray(proj.xy.numpy()), jnp.asarray(proj.conic.numpy()),
        jnp.asarray(op.numpy()), jnp.asarray(proj.rgb.numpy()))
    gj = jnp.asarray(g.numpy())
    rgb_j, feat_j, t_j = pallas_blend.blend_tiles_pallas(
        pallas_blend.to_field_major(rows[gj], 256),
        pallas_blend.to_field_major(jnp.asarray(feats)[gj], 256),
        jnp.asarray(start.numpy()), jnp.asarray(count.numpy()),
        jnp.arange(s.grid_x * s.grid_y, dtype=jnp.int32), jnp.asarray(bg),
        grid_x=s.grid_x, grid_y=s.grid_y, mode="dense", out_channels=d,
        chunk=256, interpret=True)
    for a, b in ((rgb, rgb_j), (feat, feat_j), (t, t_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5)


def _jax_loss(impl, sc, view, pm, tfx, tfy, cot):
    st = JaxSettings(image_height=H, image_width=W, tanfovx=tfx, tanfovy=tfy,
                     sh_degree=0, max_entries=2 ** 12, tile_cap=256,
                     tile_batch=4, impl=impl)

    def loss(f):
        out = jax_rasterize(
            st, jnp.asarray(sc["means"]), jnp.asarray(sc["opacities"]),
            jnp.asarray(view), jnp.asarray(pm), jnp.zeros(3, jnp.float32),
            jnp.zeros(3, jnp.float32), scales=jnp.asarray(sc["scales"]),
            rotations=jnp.asarray(sc["rotations"]),
            colors_precomp=jnp.asarray(sc["colors"]), features=f)
        return jnp.sum(out.feature_map * jnp.asarray(cot))
    return loss


def test_feature_grads_match_jax_vjp_and_xla_autodiff():
    """TestDenseCustomVJP::test_feature_grads_match_xla_autodiff for the
    port: value rtol 1e-5, d(features) atol 3e-5, against both JAX routes;
    every other input gets no gradient."""
    sc, view, pm, tfx, tfy = _case(0)
    rng = np.random.default_rng(0)
    feats = rng.uniform(0, 1, (N, 64)).astype(np.float32)
    cot = rng.normal(size=(64, H, W)).astype(np.float32)
    v_x, g_x = jax.value_and_grad(
        _jax_loss("xla", sc, view, pm, tfx, tfy, cot))(jnp.asarray(feats))
    v_p, g_p = jax.value_and_grad(
        _jax_loss("pallas", sc, view, pm, tfx, tfy, cot))(jnp.asarray(feats))

    s = RasterizeSettings(H, W, tfx, tfy, 0, max_entries=2 ** 12,
                          impl="pallas")
    f = torch.tensor(feats, requires_grad=True)
    means = torch.tensor(sc["means"], requires_grad=True)
    colors = torch.tensor(sc["colors"], requires_grad=True)
    out = rasterize(s, means, sc["opacities"], view, pm,
                    np.zeros(3, np.float32), np.zeros(3, np.float32),
                    scales=sc["scales"], rotations=sc["rotations"],
                    colors_precomp=colors, features=f, device="cpu")
    assert out.feature_map.shape == (64, H, W) and out.live_total is None
    loss = (out.feature_map * torch.from_numpy(cot)).sum()
    loss.backward()
    for v, g in ((v_x, g_x), (v_p, g_p)):
        np.testing.assert_allclose(float(loss.detach()), float(v), rtol=1e-5)
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(g), atol=3e-5)
    assert means.grad is None and colors.grad is None


def test_auto_refuses_a_geometry_gradient():
    """Under impl="auto" dense features take the XLA route, as JAX's
    "auto" does: the geometry gradients no kernel route gives (the port
    raised here before the XLA route was ported) are JAX's impl="auto"
    ones, with the map and d(features); images atol 1e-5, gradients 2e-5
    of the largest."""
    sc, view, pm, tfx, tfy = _case(0)
    rng = np.random.default_rng(6)
    feats = rng.uniform(0, 1, (N, 8)).astype(np.float32)
    cot = rng.normal(size=(8, H, W)).astype(np.float32)
    cot_rgb = rng.normal(size=(3, H, W)).astype(np.float32)
    st = JaxSettings(image_height=H, image_width=W, tanfovx=tfx,
                     tanfovy=tfy, sh_degree=0, max_entries=2 ** 12)
    z = np.zeros(3, np.float32)

    def jloss(a):
        out = jax_rasterize(st, a["means"], jnp.asarray(sc["opacities"]),
                            jnp.asarray(view), jnp.asarray(pm), z, z,
                            scales=jnp.asarray(sc["scales"]),
                            rotations=jnp.asarray(sc["rotations"]),
                            colors_precomp=a["colors"], features=a["feats"])
        return (jnp.sum(out.feature_map * cot) + jnp.sum(out.rgb * cot_rgb),
                out.feature_map)

    arrays = dict(means=sc["means"], colors=sc["colors"], feats=feats)
    (_, ref_map), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    t = {k: torch.tensor(v, requires_grad=True) for k, v in arrays.items()}
    out = rasterize(RasterizeSettings(H, W, tfx, tfy, 0, max_entries=2 ** 12),
                    t["means"], sc["opacities"], view, pm, z, z,
                    scales=sc["scales"], rotations=sc["rotations"],
                    colors_precomp=t["colors"], features=t["feats"],
                    device="cpu")
    assert out.feature_map.shape == (8, H, W)
    ((out.feature_map * torch.from_numpy(cot)).sum()
     + (out.rgb * torch.from_numpy(cot_rgb)).sum()).backward()
    np.testing.assert_allclose(out.feature_map.detach().numpy(),
                               np.asarray(ref_map), atol=1e-5)
    for k, v in t.items():
        b = np.asarray(jgrads[k])
        scale = np.abs(b).max() + 1e-8
        assert scale > 1e-6, k
        np.testing.assert_allclose(v.grad.numpy() / scale, b / scale,
                                   atol=2e-5, err_msg=k)


def test_cov3d_dense_branch_matches_jax():
    """features with cov3d_precomp: JAX's forward-only dense branch of
    `_rasterize_pallas` (the settings' cull and live clamp, live_total
    reported)."""
    from langsplatv2_tpu_torch.ops.temporal import build_cov3d

    sc, view, pm, tfx, tfy = _case(2)
    feats = np.random.default_rng(2).uniform(0, 1, (N, 16)).astype(
        np.float32)
    cov = build_cov3d(torch.from_numpy(sc["scales"]),
                      torch.from_numpy(sc["rotations"])).numpy()
    z = np.zeros(3, np.float32)
    fields = dict(image_height=H, image_width=W, tanfovx=tfx, tanfovy=tfy,
                  sh_degree=0, max_entries=2 ** 12, impl="pallas",
                  live_entries=2 ** 11)
    ref = jax_rasterize(
        JaxSettings(**fields), jnp.asarray(sc["means"]),
        jnp.asarray(sc["opacities"]), jnp.asarray(view), jnp.asarray(pm),
        jnp.asarray(z), jnp.asarray(z), cov3d_precomp=jnp.asarray(cov),
        colors_precomp=jnp.asarray(sc["colors"]),
        features=jnp.asarray(feats))
    out = rasterize(RasterizeSettings(**fields), sc["means"],
                    sc["opacities"], view, pm, z, z, cov3d_precomp=cov,
                    colors_precomp=sc["colors"], features=feats,
                    device="cpu")
    for a, b in ((out.rgb, ref.rgb), (out.feature_map, ref.feature_map),
                 (out.final_transmittance, ref.final_transmittance)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5)
    assert int(out.live_total) == int(ref.live_total)
    assert int(out.total_entries) == int(ref.total_entries)


def test_render_weights_match_jax():
    """get_render_weights (softmax -> top-k per level, concatenated) and
    its gradient to the logits."""
    f = model_fields(50, levels=2, k=64)
    f["language_logits"] = np.random.default_rng(3).normal(
        size=(50, 128)).astype(np.float32)
    cot = np.random.default_rng(4).normal(size=(50, 128)).astype(np.float32)
    jm = type("M", (), dict(codebooks=jnp.asarray(f["codebooks"])))()

    def jloss(logits):
        jm.language_logits = logits
        w = JaxModel.get_render_weights(jm, 4)
        return jnp.sum(w * jnp.asarray(cot)), w

    (_, w_j), g_j = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(f["language_logits"]))
    model = from_numpy_params(f, device="cpu")
    model.language_logits.requires_grad_(True)
    w = model.get_render_weights(4)
    (w * torch.from_numpy(cot)).sum().backward()
    assert w.shape == (50, 128) and int((w > 0).sum(1).max()) == 8
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(w_j),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(model.language_logits.grad.numpy(),
                               np.asarray(g_j), rtol=1e-5, atol=1e-6)
