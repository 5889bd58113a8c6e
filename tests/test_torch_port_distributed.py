"""The port's tile-sharded render, losses and training steps
(langsplatv2_tpu_torch/parallel/sharding.py), its bootstrap and its
multi-process checkpoint, against the JAX package.

The port's side runs once per module: four gloo ranks on the CPU
(tests/torch_port_dist_workers.py::dist_world) render on (1, 4) and (2, 2)
meshes and differentiate the losses on (2, 2). They are held to JAX's
single-device render, losses and gradients, which is what
tests/test_sharding.py holds JAX's own sharded versions to, at its
tolerances: images atol 1e-5 and radii exact, losses rtol 1e-5,
gradients 5e-4 of their largest (the shards sum in another order)."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from langsplatv2_tpu.models.gaussians import GaussianModel as JaxModel
from langsplatv2_tpu.models.io import load_checkpoint_auto
from langsplatv2_tpu.models.renderer import render as jax_render
from langsplatv2_tpu.ops import RasterizeSettings as JaxSettings
from langsplatv2_tpu.ops import rasterize as jax_rasterize
from langsplatv2_tpu.train import trainer as jax_trainer
from langsplatv2_tpu.utils import losses as jax_losses
from langsplatv2_tpu_torch.parallel import (initialize_distributed,
                                            spawn_ranks, sync_hosts)
from langsplatv2_tpu_torch.utils.camera_math import (get_projection_matrix,
                                                     get_world_to_view)

import torch_port_dist_workers as workers

H, W = 48, 64
B = 2                 # cameras: one a data rank of the (2, 2) mesh
LAMBDA = 0.2
TOPK = 4


def _camera(t=(0.1, -0.05, 0.2)):
    """The bench camera moved off the world origin (the JAX RGB path
    renders padding rows wrong with the camera centre at exactly 0)."""
    fovy = np.radians(60)
    fovx = 2 * np.arctan(np.tan(fovy / 2) * W / H)
    w2c = get_world_to_view(np.eye(3), np.asarray(t, np.float64))
    view = np.asarray(w2c.T, np.float32)
    proj = np.asarray(w2c.T @ get_projection_matrix(0.01, 100, fovx, fovy).T,
                      np.float32)
    campos = np.asarray(np.linalg.inv(w2c.T)[3, :3], np.float32)
    return view, proj, campos, float(np.tan(fovx / 2)), float(
        np.tan(fovy / 2))


def _settings(tfx, tfy):
    return dict(image_height=H, image_width=W, tanfovx=tfx, tanfovy=tfy,
                sh_degree=0, max_entries=2 ** 14, tile_cap=256, tile_batch=2)


def _gaussians(rng, n):
    return dict(
        means3d=np.concatenate([rng.uniform(-2, 2, (n, 2)),
                                rng.uniform(2.0, 8.0, (n, 1))], 1
                               ).astype(np.float32),
        scales=rng.uniform(0.03, 0.3, (n, 3)).astype(np.float32),
        rotations=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.uniform(0.2, 0.95, (n, 1)).astype(np.float32))


def _model_fields(rng, n, language: bool) -> dict:
    g = _gaussians(rng, n)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    f = dict(xyz=g["means3d"],
             features_dc=((cols - 0.5) / 0.28209479177387814)[:, None, :],
             features_rest=np.zeros((n, 0, 3), np.float32),
             scaling=np.log(g["scales"]), rotation=g["rotations"],
             opacity=np.full((n, 1), 1.0 if language else 0.5, np.float32),
             live=np.ones(n, bool))
    if language:
        f["language_logits"] = rng.normal(size=(n, 16)).astype(np.float32)
        f["codebooks"] = rng.normal(size=(1, 16, 512)).astype(np.float32)
    return {k: v.astype(np.float32) if v.dtype != bool else v
            for k, v in f.items()}


def _cams(view, proj, campos, **per_cam):
    out = dict(views=np.stack([view] * B), projs=np.stack([proj] * B),
               camposs=np.stack([campos] * B))
    out.update({k: np.stack([v] * B) for k, v in per_cam.items()})
    return out


def _cases():
    rng = np.random.default_rng(0)
    view, proj, campos, tfx, tfy = _camera()
    s = _settings(tfx, tfy)
    g = _gaussians(rng, 150)
    shs = np.zeros((150, 1, 3), np.float32)
    shs[:, 0, :] = rng.uniform(0.1, 1.5, (150, 3))
    render = dict(settings=s, view=view, proj=proj, campos=campos,
                  bg=np.zeros(3, np.float32), shs=shs,
                  features=rng.uniform(0, 1, (150, 16)).astype(np.float32),
                  **g)
    feat_model = _model_fields(rng, 60, True)
    gt_feat = np.zeros((512, H, W), np.float32)
    gt_feat[0] = 1.0
    gt_mask = np.ones((1, H, W), np.float32)
    table = rng.normal(size=(7, 512)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    seg = rng.integers(-1, 7, (H, W)).astype(np.int32)
    common = dict(settings=s, bg=np.zeros(3, np.float32), topk=TOPK,
                  model=feat_model)
    pixel = dict(common, space="pixel",
                 cams=_cams(view, proj, campos, gt_a=gt_feat, gt_b=gt_mask))
    gram = dict(common, space="gram",
                cams=_cams(view, proj, campos, gt_a=table, gt_b=seg))
    rgb_model = _model_fields(rng, 40, False)
    rgb_model["scaling"] = (rgb_model["scaling"] + rng.normal(
        0, 0.6, (40, 3))).astype(np.float32)
    gt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    opt = types.SimpleNamespace(
        position_lr_init=0.002, position_lr_final=0.0002,
        position_lr_delay_mult=0.01, position_lr_max_steps=1000,
        feature_lr=0.0025, opacity_lr=0.05, scaling_lr=0.005,
        rotation_lr=0.001)
    rgb = dict(settings=s, bg=np.zeros(3, np.float32), model=rgb_model,
               lambda_dssim=LAMBDA, opt=opt,
               cams=_cams(view, proj, campos, gts=gt))
    return dict(render=render, pixel=pixel, gram=gram, rgb=rgb)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = _cases()
    root = tmp_path_factory.mktemp("dist_world")
    ckpt = str(root / "ckpt" / "chkpnt7.npz")
    ranks = spawn_ranks(workers.dist_world, 4, (cases, ckpt),
                        store_dir=root, timeout=300)
    return cases, ranks, ckpt


def _jax_model(fields):
    return JaxModel(**{k: jnp.asarray(v) for k, v in fields.items()},
                    active_sh_degree=0, max_sh_degree=0)


def _jax_args(case):
    c = case["cams"]
    return (JaxSettings(**case["settings"]), jnp.asarray(c["views"][0]),
            jnp.asarray(c["projs"][0]), jnp.asarray(c["camposs"][0]),
            jnp.asarray(case["bg"]))


def _assert_grads(port: dict, ref: dict):
    for k, b in ref.items():
        b = np.asarray(b)
        assert port[k].shape == b.shape, k
        if not b.size:          # features_rest at SH degree 0
            continue
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(port[k] / scale, b / scale, atol=5e-4,
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_frame(world):
    case = world[0]["render"]
    j = {k: jnp.asarray(v) for k, v in case.items() if k != "settings"}
    out = jax.jit(lambda: jax_rasterize(
        JaxSettings(**case["settings"]), j["means3d"], j["opacities"],
        j["view"], j["proj"], j["campos"], j["bg"], scales=j["scales"],
        rotations=j["rotations"], shs=j["shs"], features=j["features"]))()
    return out


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_rasterize_sharded_matches_single_device(world, jax_frame, mesh):
    _, ranks, _ = world
    for r in ranks:     # every rank holds the gathered images
        out = r[f"render_{mesh}"]
        np.testing.assert_allclose(out["rgb"], np.asarray(jax_frame.rgb),
                                   atol=1e-5)
        np.testing.assert_allclose(out["feat"],
                                   np.asarray(jax_frame.feature_map),
                                   atol=1e-5)
        np.testing.assert_allclose(
            out["t"], np.asarray(jax_frame.final_transmittance), atol=1e-5)
        np.testing.assert_array_equal(out["radii"],
                                      np.asarray(jax_frame.radii))


def _jax_feature_loss(case):
    """JAX's single-device loss and gradients of the feature parameters."""
    model = _jax_model(case["model"])
    s, view, proj, campos, bg = _jax_args(case)
    c = case["cams"]
    gt_a, gt_b = jnp.asarray(c["gt_a"][0]), jnp.asarray(c["gt_b"][0])

    def loss(params):
        m = model.replace(**params)
        out = jax_render(s, m, view, proj, campos, bg, include_feature=True,
                         topk=TOPK)
        wmap = out.language_feature_weight_map
        if case["space"] == "gram":
            return jax_trainer.gram_cos_loss(m.codebooks, wmap, gt_a, gt_b,
                                             0)
        feat = m.compute_layer_feature_map(wmap, 0)
        mask = gt_b.astype(feat.dtype)
        return jax_losses.cos_loss(feat * mask, gt_a * mask)

    return jax.jit(jax.value_and_grad(loss))(
        jax_trainer.feature_params(model))


@pytest.fixture(scope="module")
def jax_features(world):
    cases = world[0]
    return {k: _jax_feature_loss(cases[k]) for k in ("pixel", "gram")}


@pytest.mark.parametrize("space", ["pixel", "gram"])
def test_feature_loss_and_grads_match(world, jax_features, space):
    """The camera-mean loss and the logits' and codebooks' gradients,
    summed over the (2, 2) mesh, against JAX's single-device ones; the
    step reports the same loss."""
    _, ranks, _ = world
    loss_ref, grads_ref = jax_features[space]
    for r in ranks:
        np.testing.assert_allclose(r[space]["loss"], float(loss_ref),
                                   rtol=1e-5)
        np.testing.assert_allclose(r[space]["step_loss"], float(loss_ref),
                                   rtol=1e-5)
        _assert_grads(r[space]["grads"], grads_ref)


@pytest.fixture(scope="module")
def jax_rgb(world):
    case = world[0]["rgb"]
    model = _jax_model(case["model"])
    s, view, proj, campos, bg = _jax_args(case)
    gt = jnp.asarray(case["cams"]["gts"][0])

    def loss(params, dummy):
        m = model.replace(**params)
        out = jax_render(s, m, view, proj, campos, bg, means2d_dummy=dummy)
        l1 = jax_losses.l1_loss(out.render, gt)
        total = (1 - LAMBDA) * l1 + LAMBDA * (
            1.0 - jax_losses.ssim(out.render, gt))
        return total, (out.radii, l1)

    dummy = jnp.zeros((model.capacity, 2), jnp.float32)
    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jax_trainer.rgb_params(model), dummy)


def test_rgb_loss_and_grads_match(world, jax_rgb):
    """The RGB loss (strips gathered over "tile" for SSIM) and the
    gradients of the six geometry fields and of the means2D carrier,
    summed over the (2, 2) mesh."""
    _, ranks, _ = world
    (loss_ref, (radii_ref, l1_ref)), (g_ref, d_ref) = jax_rgb
    for r in ranks:
        out = r["rgb"]
        np.testing.assert_allclose(out["loss"], float(loss_ref), rtol=1e-5)
        np.testing.assert_allclose(out["l1"], float(l1_ref), rtol=1e-5)
        np.testing.assert_array_equal(out["radii"][0], np.asarray(radii_ref))
        _assert_grads(out["grads"], g_ref)
        _assert_grads({"d": out["dummy"]}, {"d": d_ref})


def test_rgb_step_densify_statistics(world, jax_rgb):
    """One (2, 2) step over two cameras from a fresh model: it moves xyz,
    and the statistics are the batch's: max_radii2d the radii, denom two
    for a Gaussian both cameras see, xyz_gradient_accum the norm of the
    carrier's gradient of the camera mean (JAX's single-camera one)."""
    _, ranks, _ = world
    (loss_ref, (radii_ref, _)), (_g, d_ref) = jax_rgb
    radii = np.asarray(radii_ref)
    vis = radii > 0
    accum = np.where(vis, np.linalg.norm(np.asarray(d_ref)[:, :2], axis=-1),
                     0.0)
    for r in ranks:
        out = r["rgb"]
        assert out["xyz_moved"] > 0
        np.testing.assert_allclose(out["step_loss"], float(loss_ref),
                                   rtol=1e-5)
        assert out["num_visible"] == int(vis.sum())
        np.testing.assert_array_equal(out["max_radii2d"],
                                      np.where(vis, radii, 0))
        np.testing.assert_array_equal(out["denom"][:, 0], 2.0 * vis)
        scale = accum.max()
        assert scale > 0
        np.testing.assert_allclose(out["xyz_gradient_accum"][:, 0] / scale,
                                   accum / scale, atol=5e-4)


def test_initialize_distributed_single_process_noop(monkeypatch):
    """Without arguments or torchrun's environment: no process group, False,
    and a barrier that returns at once, twice over."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed() is False
    sync_hosts()
    sync_hosts("post")


def test_checkpoint_multihost_read_by_jax(world):
    """Rank 0 alone wrote the checkpoint (its extra says rank 0), and JAX's
    loader reads the model back equal to the fields."""
    cases, _, ckpt = world
    model, iteration = load_checkpoint_auto(ckpt)
    assert iteration == 7
    for k, v in cases["pixel"]["model"].items():
        np.testing.assert_array_equal(np.asarray(getattr(model, k)), v)
    with np.load(ckpt) as data:
        assert '"rank": 0' in str(data["manifest"])
