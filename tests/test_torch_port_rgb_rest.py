"""The rest of the port's geometry phase against the JAX package: gradient
accumulation in `train_rgb` (the summed gradients and the means2D
carrier's running sum, the xyz schedule at the true iteration, no update
on the last iteration, the carry's rows through densification) and a
step at SH degree 4.

JAX side: impl="pallas", K1, K2 and K7 in interpret mode on the CPU; port
side: device="cpu", the kernels' plain versions. The scene and cameras
are tests/test_torch_port_rgb_train.py's.
"""
import jax.numpy as jnp
import numpy as np
import torch

from langsplatv2_tpu.scene.cameras import Camera as JaxCamera
from langsplatv2_tpu.train import trainer as jax_trainer
from langsplatv2_tpu_torch.models import gaussians as gm
from langsplatv2_tpu_torch.scene.cameras import Camera
from langsplatv2_tpu_torch.train import trainer

from test_torch_port_rgb_train import (MAX_ENTRIES, N, _cameras, _opt,
                                       _port_model, _scene)


def _run_both(jm0, images, opt, accum_iter):
    """train_rgb in both packages; the port's run records the gradients
    each Adam step applies."""
    jm, _, jlogs = jax_trainer.train_rgb(
        jm0, _cameras(JaxCamera, images), opt, 2.0, seed=0,
        max_entries=MAX_ENTRIES, impl="pallas", accum_iter=accum_iter)
    model = _port_model(jm0)
    optimizer = trainer.make_rgb_optimizer(opt, model, accum_iter)
    applied = []
    step = optimizer.step

    def recorded_step(*a, **k):
        applied.append({g["name"]: g["params"][0].grad.clone()
                        for g in optimizer.param_groups})
        return step(*a, **k)
    optimizer.step = recorded_step
    model, _, logs = trainer.train_rgb(
        model, _cameras(Camera, images), opt, 2.0, seed=0,
        max_entries=MAX_ENTRIES, accum_iter=accum_iter, optimizer=optimizer,
        device="cpu")
    return jm, jlogs, model, logs, applied


def test_rgb_accum_matches_jax():
    """accum_iter = 2 over 5 iterations: updates at 2 and 4 on the summed
    gradients, none at 5. Losses at rtol 1e-5; the parameters at rtol /
    atol 1e-5 on the entries whose applied gradient at each update is 0
    or above 1e-4 of that update's largest, and at least 70% of the
    touched entries of each field compared
    (test_torch_port_rgb_train.py's rule); the densification statistics,
    which read the carrier's running sum at every iteration: the
    gradient-norm sums scale-normalized at 5e-5, the counts and radii
    equal."""
    jm0, images = _scene(256)
    jm, jlogs, model, logs, applied = _run_both(jm0, images,
                                                _opt(iterations=5), 2)
    assert len(applied) == 2
    np.testing.assert_allclose(logs.losses, jlogs.losses, rtol=1e-5)
    for name in trainer.RGB_PARAM_NAMES:
        gs = torch.stack([g[name] for g in applied]).abs()
        floor = 1e-4 * gs.flatten(1).max(1).values
        tiny = (gs > 0) & (gs <= floor.reshape(-1, *[1] * (gs.dim() - 1)))
        compared = ~tiny.any(0).numpy()
        mine = getattr(model, name).detach().numpy()
        np.testing.assert_allclose(mine[compared],
                                   np.asarray(getattr(jm, name))[compared],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
        never = (gs == 0).all(0).numpy()
        np.testing.assert_array_equal(
            mine[never], np.asarray(getattr(jm0, name))[never])
        touched = int((~never).sum())
        assert compared[~never].sum() >= 0.7 * touched > 0, name
    acc = model.xyz_gradient_accum.numpy()
    ref = np.asarray(jm.xyz_gradient_accum)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(acc / scale, ref / scale, atol=5e-5)
    np.testing.assert_array_equal(model.denom.numpy(), np.asarray(jm.denom))
    np.testing.assert_array_equal(model.max_radii2d.numpy(),
                                  np.asarray(jm.max_radii2d))


def test_rgb_accum_densify_event_matches_jax():
    """accum_iter = 3 with a densify event at iteration 2, mid-accumulation,
    that overflows a full capacity: the same event, live count and grown
    capacity as JAX's (the split noise differs, so later steps are not
    compared)."""
    opt = _opt(iterations=3, densify_from_iter=1, densification_interval=2,
               densify_until_iter=3, densify_grad_threshold=2e-5)
    jm0, images = _scene(N)
    jm, jlogs, model, logs, _ = _run_both(jm0, images, opt, 3)
    assert logs.events == jlogs.events and len(logs.events) == 1
    assert logs.events[0][0] == 2 and logs.events[0][2] > N
    assert model.capacity == jm.capacity > N
    assert int(model.num_live) == int(jm.num_live)
    np.testing.assert_allclose(logs.losses[:2], jlogs.losses[:2], rtol=1e-5)
    assert np.isfinite(logs.losses).all()


def test_densify_carries_the_accumulation():
    """run_densify gives the accumulation carry the moments' row surgery
    (JAX's bundle of opt_state and accum, trainer.py:721-727): grown rows
    zero, the slots that received a Gaussian zero, the rows of Gaussians
    kept in place as they were."""
    jm0, _ = _scene(N)
    model = _port_model(jm0)
    opt = _opt(densify_grad_threshold=2e-5)
    optimizer = trainer.make_rgb_optimizer(opt, model, 3)
    with torch.no_grad():
        model.xyz_gradient_accum.fill_(1.0)
        model.denom.fill_(1.0)
    carry = trainer.init_rgb_accum(model)
    rng = torch.Generator().manual_seed(0)
    for t in (*carry["grads"].values(), carry["means2d"]):
        t.copy_(torch.rand(t.shape, generator=rng) + 1.0)
    before = {k: v.clone() for k, v in carry["grads"].items()}
    live_before = model.live.clone()
    new = trainer.run_densify(model, optimizer, torch.Generator(), opt, 2.0,
                              0.0, carry=carry)
    cap = new.capacity
    assert cap > N and carry["means2d"].shape == (cap, 2)
    kept = torch.zeros(cap, dtype=torch.bool)
    kept[:N] = live_before & new.live[:N] & (new.xyz[:N] == model.xyz).all(1)
    for name, v in carry["grads"].items():
        assert v.shape[0] == cap, name
        assert not v[N:].any(), name
        torch.testing.assert_close(v[:N][kept[:N]], before[name][kept[:N]],
                                   atol=0, rtol=0)
    placed = new.live & ~kept
    assert placed.any() and not carry["means2d"][placed].any()
    for name, v in carry["grads"].items():
        assert not v[placed].any(), name


def _sh4_scene():
    """_scene's Gaussians at SH degree 4, the 24 rest coefficients
    random."""
    jm, images = _scene(256)
    rng = np.random.default_rng(1)
    live = np.asarray(jm.live)
    rest = np.where(live[:, None, None],
                    0.2 * rng.normal(size=(256, 24, 3)), 0.0)
    return jm.replace(features_rest=jnp.asarray(rest, jnp.float32),
                      active_sh_degree=4, max_sh_degree=4), images


def test_sh4_step_matches_jax():
    """Two geometry steps at SH degree 4: losses at rtol 1e-5 and the
    parameters after Adam at rtol / atol 1e-5 (the first step moves each
    entry with a gradient by the rate, at the sign its gradient has in
    both packages: entries below 1e-4 of the largest are left out as in
    test_torch_port_rgb_train.py), features_rest's 24 coefficients
    included."""
    jm0, images = _sh4_scene()
    jm, jlogs, model, logs, applied = _run_both(jm0, images,
                                                _opt(iterations=2), 1)
    assert tuple(model.features_rest.shape) == (256, 24, 3)
    np.testing.assert_allclose(logs.losses, jlogs.losses, rtol=1e-5)
    for name in trainer.RGB_PARAM_NAMES:
        gs = torch.stack([g[name] for g in applied]).abs()
        floor = 1e-4 * gs.flatten(1).max(1).values
        tiny = (gs > 0) & (gs <= floor.reshape(-1, *[1] * (gs.dim() - 1)))
        compared = ~tiny.any(0).numpy()
        np.testing.assert_allclose(
            getattr(model, name).detach().numpy()[compared],
            np.asarray(getattr(jm, name))[compared], rtol=1e-5, atol=1e-5,
            err_msg=name)
    assert float(applied[0]["features_rest"][:, 15:].abs().max()) > 0
    assert gm.compact(model).features_rest.shape[1] == 24
