"""The rest of the port's feature phase against the JAX package: gradient
accumulation (`accum_iter`) and camera batches (`cam_batch`), on the exact
and the capped routes, as tests/test_training.py holds JAX's own.

JAX side: impl="pallas" (its kernels in interpret mode on the CPU). Port
side: device="cpu" (every kernel wrapper runs its plain version). Both
packages get the same numpy scene: 30 Gaussians in two halves, two
cameras 0.15 apart sharing one (H, W, fov) signature, a two-segment GT.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.models import io as jax_io
from langsplatv2_tpu.models.gaussians import GaussianModel as JaxModel
from langsplatv2_tpu.train import trainer as jax_trainer
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.train import trainer

from torch_port_fixtures import two_camera_feature_scene

K = 16


def make_opt():
    return types.SimpleNamespace(language_feature_lr=0.01, vq_layer_num=1,
                                 codebook_size=K)


def two_camera_scene(seed: int = 5):
    """(JAX model, cameras) of torch_port_fixtures.two_camera_feature_scene;
    the port's model is made from the same fields by port_model."""
    fields, cams = two_camera_feature_scene(seed, k=K)
    jm = JaxModel(**{k: jnp.asarray(v) for k, v in fields.items()},
                  active_sh_degree=0, max_sh_degree=3)
    return jm, cams


def port_model(jm):
    return from_numpy_params(
        {k: np.asarray(getattr(jm, k)) for k in jax_io.MODEL_FIELDS
         if getattr(jm, k) is not None},
        active_sh_degree=jm.active_sh_degree, max_sh_degree=jm.max_sh_degree,
        device="cpu")


def run_port(jm, cams, applied=None, **kw):
    """train_features on the port; `applied`, when a list, gets the
    gradients each Adam step applies."""
    model = port_model(jm)
    optimizer = trainer.make_feature_optimizer(make_opt(), model)
    if applied is not None:
        step = optimizer.step

        def recorded_step(*a, **k):
            applied.append({g["name"]: g["params"][0].grad.clone()
                            for g in optimizer.param_groups})
            return step(*a, **k)
        optimizer.step = recorded_step
    model, _, logs = trainer.train_features(
        model, cams, make_opt(), "", 1, device="cpu", optimizer=optimizer,
        feature_cache={}, **kw)
    return model, logs


def run_jax(jm, cams, **kw):
    model, _, logs = jax_trainer.train_features(
        jm, cams, make_opt(), "", 1, impl="pallas", tile_cap=256,
        feature_cache={}, **kw)
    return model, logs


def assert_params_match_jax(port, ref, start, applied, atol):
    """The port's parameters against JAX's at `atol` on the entries whose
    applied gradient at each update is 0 or above 1e-6 of that update's
    largest (test_torch_port_train.py::test_final_parameters_match_jax's
    rule with a floor ten times lower): from Adam's second step on, an
    entry whose gradients sit at the two packages' summation noise (here
    two logits, at 1e-8 of the largest) moves by a different fraction of
    the rate. Untouched entries keep their start values; at least 80% of
    the touched ones are compared."""
    for name in ("language_logits", "codebooks"):
        gs = torch.stack([g[name] for g in applied]).abs()
        floor = 1e-6 * gs.flatten(1).max(1).values
        tiny = (gs > 0) & (gs <= floor.reshape(-1, *[1] * (gs.dim() - 1)))
        compared = ~tiny.any(0).numpy()
        never = (gs == 0).all(0).numpy()
        mine = getattr(port, name).detach().numpy()
        np.testing.assert_allclose(mine[compared],
                                   np.asarray(getattr(ref, name))[compared],
                                   rtol=0, atol=atol, err_msg=name)
        np.testing.assert_array_equal(
            mine[never], np.asarray(getattr(start, name))[never])
        touched = int((~never).sum())
        assert compared[~never].sum() >= 0.8 * touched > 0, name


def test_accum_iter_steps_every_n():
    """With accum_iter = 3 Adam applies only at iterations 3 and 6, the
    summed gradients of the three iterations before, and never at the last
    one (reference train.py:261)."""
    jm, cams = two_camera_scene()
    snapshots = {}
    grads = {}

    def on_iter(it, m, _opt, _metrics):
        snapshots[it] = m.language_logits.detach().clone()
        grads[it] = m.language_logits.grad.clone()

    run_port(jm, cams[:1], iterations=7, topk=4, max_entries=2 ** 14,
             accum_iter=3, on_iteration=on_iter)
    base = torch.tensor(np.asarray(jm.language_logits))
    assert torch.equal(snapshots[1], base) and torch.equal(snapshots[2], base)
    assert not torch.equal(snapshots[3], snapshots[2])
    assert torch.equal(snapshots[4], snapshots[3])
    assert torch.equal(snapshots[5], snapshots[3])
    assert not torch.equal(snapshots[6], snapshots[5])
    assert torch.equal(snapshots[7], snapshots[6])
    # The gradients sum in .grad until an update clears them.
    assert grads[3].abs().sum() == 0 and grads[6].abs().sum() == 0
    assert grads[2].abs().sum() > grads[1].abs().sum() > 0


@pytest.fixture(scope="module")
def accum_runs():
    jm, cams = two_camera_scene()
    kw = dict(iterations=7, topk=4, max_entries=2 ** 14, seed=11)
    applied, applied_batched = [], []
    return dict(port=run_port(jm, cams, accum_iter=3, applied=applied, **kw),
                jax=run_jax(jm, cams, accum_iter=3, **kw),
                port_batched=run_port(jm, cams, cam_batch=3,
                                      applied=applied_batched, **kw),
                applied=applied, applied_batched=applied_batched,
                jm=jm, cams=cams, kw=kw)


def test_accum_training_matches_jax(accum_runs):
    """accum_iter = 3 over 7 iterations: two updates (3 and 6); losses at
    rtol 1e-5 and the parameters at atol 1e-5 (assert_params_match_jax)."""
    (m, logs), (jm, jlogs) = accum_runs["port"], accum_runs["jax"]
    assert len(accum_runs["applied"]) == 2
    np.testing.assert_allclose(logs.losses, jlogs.losses, rtol=1e-5)
    assert_params_match_jax(m, jm, accum_runs["jm"], accum_runs["applied"],
                            1e-5)


def test_cam_batch_matches_accum(accum_runs):
    """cam_batch = 3 is accumulation semantics: the port's batched run
    reproduces its accum_iter = 3 run, the parameters at atol 3e-5 and the
    losses at rtol 3e-5 / atol 1e-6
    (tests/test_training.py::test_cam_batch_matches_accum), and JAX's
    cam_batch = 3 run at the same tolerances (assert_params_match_jax)."""
    m_bat, logs_bat = accum_runs["port_batched"]
    m_seq, logs_seq = accum_runs["port"]
    assert len(accum_runs["applied_batched"]) == 2
    for name in ("language_logits", "codebooks"):
        np.testing.assert_allclose(getattr(m_bat, name).detach().numpy(),
                                   getattr(m_seq, name).detach().numpy(),
                                   rtol=0, atol=3e-5, err_msg=name)
    np.testing.assert_allclose(logs_bat.losses, logs_seq.losses, rtol=3e-5,
                               atol=1e-6)
    jb, jlogs_bat = run_jax(accum_runs["jm"], accum_runs["cams"],
                            cam_batch=3, **accum_runs["kw"])
    assert_params_match_jax(m_bat, jb, accum_runs["jm"],
                            accum_runs["applied_batched"], 3e-5)
    np.testing.assert_allclose(logs_bat.losses, jlogs_bat.losses, rtol=3e-5,
                               atol=1e-6)


def test_cam_batch_capped_matches_accum():
    """cam_batch with the budget-capped route (tile_budget 1e-6, cap 128):
    the batched run reproduces the accum_iter = 2 run, and JAX's batched
    capped run, at 3e-5."""
    jm, cams = two_camera_scene()
    kw = dict(iterations=5, topk=4, max_entries=2 ** 14, tile_budget=1e-6,
              tile_budget_cap=128, seed=11)
    applied = []
    m_seq, logs_seq = run_port(jm, cams, accum_iter=2, **kw)
    m_bat, logs_bat = run_port(jm, cams, cam_batch=2, applied=applied, **kw)
    assert list(logs_bat.exp_budget.values()) == list(
        logs_seq.exp_budget.values())
    np.testing.assert_allclose(m_bat.language_logits.detach().numpy(),
                               m_seq.language_logits.detach().numpy(),
                               rtol=0, atol=3e-5)
    np.testing.assert_allclose(logs_bat.losses, logs_seq.losses, rtol=3e-5,
                               atol=1e-6)
    jb, jlogs = run_jax(jm, cams, cam_batch=2, **kw)
    assert_params_match_jax(m_bat, jb, jm, applied, 3e-5)
    np.testing.assert_allclose(logs_bat.losses, jlogs.losses, rtol=3e-5,
                               atol=1e-6)


def test_cam_batch_groups_split_like_jax(monkeypatch):
    """Groups end on absolute multiples of cam_batch and split at
    align_iterations and at curriculum layer changes (two layers over
    10,000 iterations change at 5,000), starting mid-way from first_iter:
    the port's group sizes and layers are those of JAX's loop (its step
    replaced by a stub that only records them)."""
    jm, cams = two_camera_scene()
    jm = jm.replace(
        language_logits=jnp.concatenate([jm.language_logits] * 2, 1),
        codebooks=jnp.concatenate([jm.codebooks] * 2, 0))
    sizes = {"port": [], "jax": []}
    orig_port = trainer.make_feature_group_step

    def port_group(*a, **k):
        step = orig_port(*a, **k)

        def call(model, views, *args, **kwargs):
            sizes["port"].append((len(views), args[2]))
            return step(model, views, *args, **kwargs)
        return call

    def jax_group(*a, **k):
        # JAX's grouping lives in its loop; its step is not compiled here
        # (a live_total of -1 reads as a route without telemetry).
        def call(model, opt_state, views, *args, **kwargs):
            sizes["jax"].append((int(views.shape[0]), kwargs["layer_idx"]))
            return model, opt_state, {
                "losses": np.zeros(views.shape[0], np.float32),
                "live_total": jnp.asarray(-1)}
        return call

    monkeypatch.setattr(trainer, "make_feature_group_step", port_group)
    monkeypatch.setattr(jax_trainer, "make_feature_train_step_batched",
                        jax_group)
    kw = dict(first_iter=4994, iterations=5006, topk=2, max_entries=2 ** 14,
              cam_batch=4, align_iterations={5003}, seed=3)
    run_port(jm, cams, **kw)
    run_jax(jm, cams, **kw)
    # 4995-4996 (to the multiple 4996), 4997-5000, 5001-5003 (align),
    # 5004, 5005-5006; layer 1 from 5000 (int(5000 / 10000 * 2) = 1):
    # 4997-4999, 5000.
    assert sizes["port"] == sizes["jax"]
    assert [s for s, _ in sizes["port"]] == [2, 3, 1, 3, 1, 2]
