"""The port's geometry (RGB) training slice against the JAX package:
`train_rgb` for 3 steps in both on a small scene with the same camera order
(losses, the first step's gradients, the parameters after Adam), and a
loop that crosses a densify event with capacity growth.

JAX side: impl="pallas", so its RGB path runs K1, K2 and K7 in Pallas
interpret mode on the CPU. Port side: device="cpu", so every kernel
wrapper runs its plain version.
"""
import math
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.models import gaussians as jax_gm
from langsplatv2_tpu.models import io as jax_io
from langsplatv2_tpu.models.renderer import make_settings as jax_settings
from langsplatv2_tpu.models.renderer import render as jax_render
from langsplatv2_tpu.scene.cameras import Camera as JaxCamera
from langsplatv2_tpu.train import trainer as jax_trainer
from langsplatv2_tpu.utils import losses as jax_losses
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.scene.cameras import Camera
from langsplatv2_tpu_torch.train import trainer

H, W = 48, 64
N = 200
MAX_ENTRIES = 2 ** 14
YAWS = (-4.0, 4.0)


def _opt(**over):
    base = dict(
        iterations=3, position_lr_init=0.00016, position_lr_final=0.0000016,
        position_lr_delay_mult=0.01, position_lr_max_steps=30_000,
        feature_lr=0.0025, opacity_lr=0.05, scaling_lr=0.005,
        rotation_lr=0.001, percent_dense=0.01, lambda_dssim=0.2,
        densification_interval=100, opacity_reset_interval=3000,
        densify_from_iter=500, densify_until_iter=0,
        densify_grad_threshold=0.0002)
    base.update(over)
    return types.SimpleNamespace(**base)


def _scene(capacity: int):
    """N Gaussians from create_from_pcd in front of the cameras, with
    random logit opacity, scales and degree-3 SH; `capacity - N` dead
    rows. Returns (JAX model, cameras' images)."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-1.5, 1.5, (N, 2)),
                          rng.uniform(2.0, 6.0, (N, 1))], 1).astype(np.float32)
    cols = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    jm = jax_gm.create_from_pcd(pts, cols, 1.0, capacity=capacity)
    live = np.arange(capacity) < N
    op = np.where(live[:, None], rng.uniform(-1, 2, (capacity, 1)), 0.0)
    sc = np.where(live[:, None], np.log(rng.uniform(0.03, 0.2, (capacity, 3))),
                  0.0)
    rest = np.where(live[:, None, None],
                    0.2 * rng.normal(size=(capacity, 15, 3)), 0.0)
    jm = jm.replace(opacity=jnp.asarray(op, jnp.float32),
                    scaling=jnp.asarray(sc, jnp.float32),
                    features_rest=jnp.asarray(rest, jnp.float32),
                    active_sh_degree=3)
    images = [rng.uniform(0, 1, (3, H, W)).astype(np.float32) for _ in YAWS]
    return jm, images


def _cameras(cls, images):
    """Two views 8 degrees apart, centred off the origin: with a camera
    centre exactly at the origin, the padding rows (xyz = 0) get NaN
    view directions, hence NaN colours, which the JAX package's Pallas RGB
    path lets into every tile (ROADMAP.md, Queue 3); the port is unaffected
    but the comparison would not be."""
    fovy = math.radians(60)
    fovx = 2 * math.atan(math.tan(fovy / 2) * W / H)
    cams = []
    for i, (deg, img) in enumerate(zip(YAWS, images)):
        t = math.radians(deg)
        R = np.array([[math.cos(t), 0, math.sin(t)], [0, 1, 0],
                      [-math.sin(t), 0, math.cos(t)]])
        cams.append(cls(i, R, np.array([0.05, -0.03, 0.1]), fovx, fovy, img,
                        f"c{i}", i))
    return cams


def _port_model(jm):
    fields = {k: np.asarray(getattr(jm, k)) for k in jax_io.MODEL_FIELDS
              if getattr(jm, k) is not None}
    return from_numpy_params(fields, active_sh_degree=jm.active_sh_degree,
                             max_sh_degree=jm.max_sh_degree,
                             spatial_lr_scale=jm.spatial_lr_scale,
                             device="cpu")


def _run_both(capacity: int, opt):
    jm0, images = _scene(capacity)
    jm, _, jlogs = jax_trainer.train_rgb(
        jm0, _cameras(JaxCamera, images), opt, 2.0, seed=0,
        max_entries=MAX_ENTRIES, impl="pallas")
    grads = []

    def keep(_it, m, _opt, metrics):
        # (After a densify event the model's tensors are new, without .grad.)
        grads.append({k: getattr(m, k).grad for k in trainer.RGB_PARAM_NAMES})
        grads[-1]["means2d"] = metrics["means2d_grad"]
        grads[-1] = {k: None if g is None else g.clone()
                     for k, g in grads[-1].items()}

    model, optimizer, logs = trainer.train_rgb(
        _port_model(jm0), _cameras(Camera, images), opt, 2.0, seed=0,
        max_entries=MAX_ENTRIES, on_iteration=keep, device="cpu")
    return dict(jm0=jm0, jm=jm, jlogs=jlogs, model=model, logs=logs,
                grads=grads, images=images)


@pytest.fixture(scope="module")
def trained():
    return _run_both(256, _opt())


def test_rgb_losses_match_jax(trained):
    assert len(trained["logs"].losses) == 3
    np.testing.assert_allclose(trained["logs"].losses,
                               trained["jlogs"].losses, rtol=1e-5)
    assert trained["logs"].events == trained["jlogs"].events == []


def _jax_first_step_grads(jm, images):
    """The JAX step's loss (render with the means2D carrier, L1 + SSIM) under
    jax.grad at the initial parameters, on the first camera drawn."""
    cam = _cameras(JaxCamera, images)[random.Random(0).randint(0, 1)]
    st = jax_settings(cam, jm.active_sh_degree, 1.0, MAX_ENTRIES,
                      impl="pallas")
    gt = jnp.asarray(cam.image)

    def loss(params, dummy):
        out = jax_render(st, jm.replace(**params),
                         jnp.asarray(cam.world_view_transform),
                         jnp.asarray(cam.full_proj_transform),
                         jnp.asarray(cam.camera_center), jnp.zeros(3),
                         means2d_dummy=dummy)
        return 0.8 * jax_losses.l1_loss(out.render, gt) + 0.2 * (
            1.0 - jax_losses.ssim(out.render, gt))

    g, g_dummy = jax.grad(loss, argnums=(0, 1))(
        jax_trainer.rgb_params(jm), jnp.zeros((jm.capacity, 2)))
    live = np.asarray(jm.live)
    out = {k: np.where(live.reshape((-1,) + (1,) * (v.ndim - 1)),
                       np.asarray(v), 0.0) for k, v in g.items()}
    out["means2d"] = np.asarray(g_dummy)
    return out


def test_rgb_first_step_gradients_match_jax(trained):
    """Scale-normalized at 5e-5 (TestRGBCustomVJP's tolerance), the
    means2D carrier included; dead rows exactly 0."""
    ref = _jax_first_step_grads(trained["jm0"], trained["images"])
    for name, g in trained["grads"][0].items():
        g = g.numpy()
        scale = float(np.abs(ref[name]).max())
        assert scale > 0, name
        np.testing.assert_allclose(g / scale, ref[name] / scale, atol=5e-5,
                                   err_msg=name)
        if name != "means2d":
            assert not g[N:].any(), name


def test_rgb_parameters_after_adam_match_jax(trained):
    """Parameters after 3 steps at rtol 1e-5 / atol 1e-5, on the entries
    whose gradient at every step is 0 or above 1e-4 of that step's largest:
    Adam (eps 1e-15) moves an entry with a rounding-level gradient by a
    full learning rate in the direction of its sign, which the two
    packages need not share. Near that floor the gradients agree to a few
    1e-3 of themselves, and so do the steps m/sqrt(v): up to 0.5% of the
    smallest rate (1.25e-4), hence atol 1e-5. Entries never touched stay
    as they were, padding rows included. Left out on this scene: xyz 8,
    features_rest 919 (of 9000 live), scaling 49, rotation 198 (of 800),
    none of features_dc and opacity; at least 70% of the touched entries
    of each field must be compared."""
    jm, model, jm0 = trained["jm"], trained["model"], trained["jm0"]
    left_out = {}
    for name in trainer.RGB_PARAM_NAMES:
        gs = torch.stack([g[name] for g in trained["grads"]]).abs()
        floor = 1e-4 * gs.flatten(1).max(1).values
        tiny = ((gs > 0) & (gs <= floor.reshape(-1, *[1] * (gs.dim() - 1))))
        compared = ~tiny.any(0).numpy()
        mine = getattr(model, name).detach().numpy()
        ref = np.asarray(getattr(jm, name))
        np.testing.assert_allclose(mine[compared], ref[compared], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        never = (gs == 0).all(0).numpy()
        np.testing.assert_array_equal(mine[never],
                                      np.asarray(getattr(jm0, name))[never])
        left_out[name] = int((~compared).sum())
        touched = int((~never).sum())
        assert touched - left_out[name] >= 0.7 * touched, (name, left_out)
    print("entries left out:", left_out)


def test_rgb_densify_event_matches_jax():
    """A loop whose densify event at step 2 overflows a full capacity: the
    same event, the same live count and the same grown capacity in both
    packages (the split noise differs, so later steps are not compared)."""
    opt = _opt(densify_from_iter=1, densification_interval=2,
               densify_until_iter=3, densify_grad_threshold=2e-5)
    r = _run_both(N, opt)
    events = r["logs"].events
    assert events == r["jlogs"].events and len(events) == 1
    assert events[0][0] == 2 and events[0][2] > N
    assert r["model"].capacity == r["jm"].capacity > N
    assert int(r["model"].num_live) == int(r["jm"].num_live)
    np.testing.assert_allclose(r["logs"].losses[:2], r["jlogs"].losses[:2],
                               rtol=1e-5)
    assert np.isfinite(r["logs"].losses).all()


def test_padding_rows_render_like_the_compacted_model():
    """With the camera centre exactly at the origin the padding rows
    (xyz = 0) have NaN colours; they must touch no tile, so the padded
    model renders as the compacted one and its gradients stay finite on
    live rows (the JAX RGB path does not, ROADMAP.md Queue 3)."""
    from langsplatv2_tpu_torch.models import gaussians as gm
    from langsplatv2_tpu_torch.models.renderer import make_settings, render

    jm, images = _scene(256)
    model = _port_model(jm)
    fovy = math.radians(60)
    fovx = 2 * math.atan(math.tan(fovy / 2) * W / H)
    cam = Camera(0, np.eye(3), np.zeros(3), fovx, fovy, images[0], "c", 0)
    assert not cam.camera_center.any()
    st = make_settings(cam, 3, 1.0, MAX_ENTRIES)
    args = (cam.world_view_transform, cam.full_proj_transform,
            cam.camera_center, np.zeros(3, np.float32))
    trainer.rgb_params(model)
    out = render(st, model, *args, device="cpu")
    ref = render(st, gm.compact(model), *args, device="cpu")
    torch.testing.assert_close(out.render, ref.render, atol=0, rtol=0)
    torch.testing.assert_close(out.final_transmittance,
                               ref.final_transmittance, atol=0, rtol=0)
    out.render.sum().backward()
    for name in trainer.RGB_PARAM_NAMES:
        assert torch.isfinite(getattr(model, name).grad[:N]).all(), name
