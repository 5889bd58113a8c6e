"""The port's checkpoint interop against the JAX package: the reference's
`chkpnt*.pth` capture tuples (models/torch_interop.py: 12- and 14-tuples,
capacity padding, the torch Adam state into the port's named-group Adam,
the tuple written back), `load_checkpoint_auto` / `resolve_checkpoint`,
and `.npz` checkpoints with their Adam state read across the packages,
the geometry optimizer at accum_iter 1 and 2 and the feature optimizer.

The tuples are built here with torch in the reference's capture() layout
(reference scene/gaussian_model.py:67-139), as tests/test_torch_interop.py
builds them, and each case runs in both packages.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.models import io as jax_io
from langsplatv2_tpu.models import torch_interop as jax_interop
from langsplatv2_tpu.train import trainer as jax_trainer
from langsplatv2_tpu.train.optimizers import GroupedOptimizer, adam_group
from langsplatv2_tpu_torch.models import io, torch_interop
from langsplatv2_tpu_torch.models.gaussians import (create_from_pcd,
                                                    init_language_features)
from langsplatv2_tpu_torch.models.renderer import render
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings
from langsplatv2_tpu_torch.train import trainer
from langsplatv2_tpu_torch.train.optimizers import (grouped_adam,
                                                   set_scheduled_lrs)

from test_torch_interop import _reference_style_tuple
from torch_port_fixtures import camera

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "language_logits", "codebooks", "max_radii2d",
          "xyz_gradient_accum", "denom", "live")


def _assert_models_equal(port, jm):
    """Every field of the port's model equals the JAX model's, bit for
    bit, and so do the scalars."""
    for name in FIELDS:
        a, b = getattr(port, name), getattr(jm, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b),
                                          err_msg=name)
    assert port.active_sh_degree == jm.active_sh_degree
    assert port.max_sh_degree == jm.max_sh_degree
    assert port.spatial_lr_scale == pytest.approx(jm.spatial_lr_scale)


@pytest.mark.parametrize("include_feature,n,capacity", [
    (False, 50, None), (True, 50, None), (False, 20, 64), (True, 20, 64)],
    ids=["rgb-12", "feature-14", "rgb-12-padded", "feature-14-padded"])
def test_capture_tuple_loads_as_in_jax(tmp_path, include_feature, n,
                                       capacity):
    """test_rgb_12_tuple, test_feature_14_tuple, test_capacity_padding:
    the tuple's fields, the iteration, the scalars and the padding (dead
    rows, identity rotations) equal JAX's reading of the same file."""
    tup = _reference_style_tuple(n=n, include_feature=include_feature)
    path = str(tmp_path / "chkpnt30000.pth")
    torch.save((tup, 30000), path)
    model, it, opt_dict = torch_interop.load_torch_checkpoint(
        path, capacity=capacity, device="cpu")
    jm, jit, _ = jax_interop.load_torch_checkpoint(path, capacity=capacity)
    assert it == jit == 30000 and opt_dict == {"state": {},
                                               "param_groups": []}
    _assert_models_equal(model, jm)
    np.testing.assert_array_equal(model.xyz[:n].numpy(), tup[1].numpy())
    assert int(model.num_live) == n
    if capacity:
        assert model.capacity == capacity
        np.testing.assert_array_equal(model.rotation[n:, 0].numpy(),
                                      np.ones(capacity - n, np.float32))


def test_auto_dispatch_and_resolve(tmp_path):
    """resolve_checkpoint prefers the .npz beside a .pth, as JAX's does,
    and load_checkpoint_auto reads both kinds."""
    tup = _reference_style_tuple(n=10)
    d = tmp_path / "model"
    d.mkdir()
    torch.save((tup, 7), str(d / "chkpnt7.pth"))
    p = io.resolve_checkpoint(str(d), 7)
    assert p == jax_io.resolve_checkpoint(str(d), 7)
    assert p.endswith(".pth")
    model, it = io.load_checkpoint_auto(p, device="cpu")
    assert it == 7 and model.capacity == 10
    io.save_checkpoint(str(d / "chkpnt7.npz"), model, None, 7)
    p = io.resolve_checkpoint(str(d), 7)
    assert p.endswith(".npz") and p == jax_io.resolve_checkpoint(str(d), 7)
    m2, it2 = io.load_checkpoint_auto(p, device="cpu")
    jm, jit = jax_io.load_checkpoint_auto(p)
    assert it2 == jit == 7
    _assert_models_equal(m2, jm)
    assert io.resolve_checkpoint(str(d), 8).endswith("chkpnt8.npz")


def _feature_model():
    rng = np.random.default_rng(3)
    n = 80
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    rng.uniform(3, 6, n)], 1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    model = create_from_pcd(pts, cols, spatial_lr_scale=1.0, max_sh_degree=1,
                            capacity=96, device="cpu")
    return init_language_features(
        model, 1, 16, generator=torch.Generator().manual_seed(1))


def test_export_load_render_parity(tmp_path):
    """The port's model -> reference .pth and .npz -> load_checkpoint_auto:
    the two render the same frame bit for bit, and JAX reads the .pth the
    port wrote as the port does."""
    model = _feature_model()
    pth, npz = str(tmp_path / "chkpnt5.pth"), str(tmp_path / "chkpnt5.npz")
    torch_interop.save_torch_checkpoint(pth, model, 5)
    io.save_checkpoint(npz, model, None, 5)
    m_t, it_t = io.load_checkpoint_auto(pth, sh_degree=1, device="cpu")
    m_n, it_n = io.load_checkpoint_auto(npz, device="cpu")
    assert it_t == it_n == 5
    jm, _ = jax_io.load_checkpoint_auto(pth, sh_degree=1)
    _assert_models_equal(m_t, jm)
    view, pm, tfx, tfy = camera(48, 64)
    s = RasterizeSettings(48, 64, tfx, tfy, 1, max_entries=2 ** 12)

    def frame(m):
        with torch.no_grad():
            out = render(s, m, view, pm, np.zeros(3, np.float32),
                         np.zeros(3, np.float32), include_feature=True,
                         topk=4, device="cpu")
        return out.render, out.language_feature_weight_map

    for a, b in zip(frame(m_t), frame(m_n)):
        assert float(a.abs().max()) > 0
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_reference_roundtrip_tuple_identity(tmp_path):
    """load(export(load(tuple))) keeps every tensor bit for bit, and the
    port's export equals JAX's export of the same model."""
    tup = _reference_style_tuple(n=30, include_feature=True)
    p1 = str(tmp_path / "a.pth")
    torch.save((tup, 3), p1)
    model, _, _ = torch_interop.load_torch_checkpoint(p1, capacity=40,
                                                      device="cpu")
    p2, p3 = str(tmp_path / "b.pth"), str(tmp_path / "c.pth")
    torch_interop.save_torch_checkpoint(p2, model, 3)
    jax_interop.save_torch_checkpoint(
        p3, jax_interop.load_torch_checkpoint(p1, capacity=40)[0], 3)
    (tup2, it2) = torch.load(p2, weights_only=False)
    (tup3, _) = torch.load(p3, weights_only=False)
    assert it2 == 3 and len(tup2) == 14
    for i in range(1, 12):
        np.testing.assert_array_equal(tup[i].numpy(), tup2[i].numpy(),
                                      err_msg=f"slot {i}")
        np.testing.assert_array_equal(tup2[i].numpy(), tup3[i].numpy(),
                                      err_msg=f"slot {i}")
    assert tup2[0] == tup[0]
    assert tup2[13] == pytest.approx(tup[13])


def _torch_rgb_adam(n=12, steps=3, seed=0):
    """The reference's geometry optimizer: one named group a parameter."""
    g = torch.Generator().manual_seed(seed)
    params = {k: torch.randn(n, *shape, generator=g, requires_grad=True)
              for k, shape in (("xyz", (3,)), ("f_dc", (1, 3)),
                               ("f_rest", (3, 3)), ("opacity", (1,)),
                               ("scaling", (3,)), ("rotation", (4,)))}
    optim = torch.optim.Adam([{"params": [p], "lr": 1e-3, "name": k}
                              for k, p in params.items()], lr=0.0, eps=1e-15)
    for _ in range(steps):
        optim.zero_grad()
        sum((p ** 2).sum() for p in params.values()).backward()
        optim.step()
    return optim


RGB_SHAPES = {"xyz": (3,), "features_dc": (1, 3), "features_rest": (3, 3),
              "opacity": (1,), "scaling": (3,), "rotation": (4,)}


def test_rgb_moments_land_in_groups():
    """A reference geometry Adam state -> the port's groups: moments padded
    to the capacity and step counts, equal to JAX's conversion."""
    n, cap = 12, 16
    opt_dict = _torch_rgb_adam(n=n).state_dict()
    port = grouped_adam({k: (torch.zeros((cap,) + s), 1e-3)
                         for k, s in RGB_SHAPES.items()})
    torch_interop.convert_torch_adam_state(opt_dict, port, cap)
    ours = GroupedOptimizer({k: adam_group(1e-3) for k in RGB_SHAPES})
    ref = jax_interop.convert_torch_adam_state(
        opt_dict, ours.init({k: jnp.zeros((cap,) + s)
                             for k, s in RGB_SHAPES.items()}), cap)
    for g in port.param_groups:
        st = port.state[g["params"][0]]
        adam = ref[g["name"]][0]
        assert int(st["step"]) == int(adam.count) == 3
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      np.asarray(adam.mu))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(adam.nu))
        assert float(st["exp_avg"][n:].abs().max()) == 0.0


def test_feature_phase_group():
    """The reference's one "language_feature" group [logits, codebooks] ->
    the port's two groups, equal to JAX's conversion; the codebooks keep
    their shape."""
    n, cap, L, K = 10, 16, 1, 16
    logits = torch.randn(n, L * K, requires_grad=True)
    codebooks = torch.randn(L, K, 512, requires_grad=True)
    optim = torch.optim.Adam([{"params": [logits, codebooks], "lr": 2.5e-3,
                               "name": "language_feature"}], lr=0.0,
                             eps=1e-15)
    for _ in range(2):
        optim.zero_grad()
        ((logits ** 2).sum() + (codebooks ** 2).sum()).backward()
        optim.step()
    opt_dict = optim.state_dict()
    port = grouped_adam({"language_logits": (torch.zeros(cap, L * K), 2.5e-3),
                         "codebooks": (torch.zeros(L, K, 512), 2.5e-3)})
    torch_interop.convert_torch_adam_state(opt_dict, port, cap)
    ours = GroupedOptimizer({"language_logits": adam_group(2.5e-3),
                             "codebooks": adam_group(2.5e-3)})
    ref = jax_interop.convert_torch_adam_state(
        opt_dict, ours.init({"language_logits": jnp.zeros((cap, L * K)),
                             "codebooks": jnp.zeros((L, K, 512))}), cap)
    for g in port.param_groups:
        st = port.state[g["params"][0]]
        adam = ref[g["name"]][0]
        assert int(st["step"]) == int(adam.count) == 2
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      np.asarray(adam.mu))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(adam.nu))
    with pytest.raises(ValueError, match="language_logits"):
        torch_interop.convert_torch_adam_state(opt_dict, port, cap + 1)


def _opt_params():
    return types.SimpleNamespace(
        position_lr_init=0.00016, position_lr_final=0.0000016,
        position_lr_delay_mult=0.01, position_lr_max_steps=30000,
        feature_lr=0.0025, opacity_lr=0.05, scaling_lr=0.005,
        rotation_lr=0.001, language_feature_lr=0.0025)


def _stepped(optimizer, params, steps, seed):
    """`steps` Adam steps of the port's optimizer on seeded gradients."""
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in params.values():
            p.grad = torch.randn(p.shape, generator=g)
        set_scheduled_lrs(optimizer)
        optimizer.step()


@pytest.mark.parametrize("phase,accum_iter", [("rgb", 1), ("rgb", 2),
                                              ("feature", 1)])
def test_npz_adam_state_read_across_packages(tmp_path, phase, accum_iter):
    """The port writes a checkpoint with its Adam state: JAX's
    load_checkpoint reads it with its own optimizer's template (the xyz
    schedule keyed by accum_iter keeps the leaf layout), and the port
    reads it back; JAX writes one, the port reads its model and moments.
    Moments and counts equal bit for bit both ways."""
    model = _feature_model()
    opt = _opt_params()
    if phase == "rgb":
        port_opt = trainer.make_rgb_optimizer(opt, model, accum_iter)
        params = trainer.rgb_params(model)
        jax_opt = jax_trainer.make_rgb_optimizer(opt, 1.0, accum_iter)
    else:
        port_opt = trainer.make_feature_optimizer(opt, model)
        params = trainer.feature_params(model)
        jax_opt = jax_trainer.make_feature_optimizer(opt)
    _stepped(port_opt, params, 3, seed=4)
    path = str(tmp_path / "port.npz")
    io.save_checkpoint(path, model, port_opt, 3, extra={"phase": phase})
    jm, _ = jax_io.load_checkpoint_auto(path)
    names = sorted(params)
    template = jax_opt.init({k: getattr(jm, k) for k in names})
    jm2, state, it, extra = jax_io.load_checkpoint(path, jm, template)
    assert it == 3 and extra == {"phase": phase}
    _assert_models_equal(model, jm2)
    by_name = {g["name"]: g["params"][0] for g in port_opt.param_groups}
    for k in names:
        st = port_opt.state[by_name[k]]
        adam = state[k][0]
        assert int(adam.count) == int(st["step"]) == 3
        np.testing.assert_array_equal(np.asarray(adam.mu),
                                      st["exp_avg"].numpy())
        np.testing.assert_array_equal(np.asarray(adam.nu),
                                      st["exp_avg_sq"].numpy())
    if phase == "rgb":
        # The scheduled group's update count (the rates it reads).
        assert int(state["xyz"][1].count) == 3

    # JAX -> the port.
    jpath = str(tmp_path / "jax.npz")
    jax_io.save_checkpoint(jpath, jm2, state, 9)
    m3, it3 = io.load_checkpoint(jpath, device="cpu")
    assert it3 == 9
    _assert_models_equal(m3, jm2)
    fresh = (trainer.make_rgb_optimizer(opt, m3, accum_iter)
             if phase == "rgb" else trainer.make_feature_optimizer(opt, m3))
    io.load_optimizer_state(jpath, fresh)
    for g in fresh.param_groups:
        st = fresh.state[g["params"][0]]
        old = port_opt.state[by_name[g["name"]]]
        assert int(st["step"]) == 3
        torch.testing.assert_close(st["exp_avg"], old["exp_avg"], atol=0,
                                   rtol=0)
        torch.testing.assert_close(st["exp_avg_sq"], old["exp_avg_sq"],
                                   atol=0, rtol=0)


def test_accum_xyz_schedule_matches_jax():
    """With accum_iter = 3 the rate the port sets before its u-th xyz
    update is the rate JAX's chain applies at its u-th (the schedule at
    iteration 3u): JAX's update over the bare Adam step of the same
    gradients, at rel 1e-5 since JAX evaluates the schedule in float32
    and the port in float64."""
    import optax

    model = _feature_model()
    port_opt = trainer.make_rgb_optimizer(_opt_params(), model, 3)
    xyz_group = next(g for g in port_opt.param_groups if g["name"] == "xyz")
    xyz = trainer.rgb_params(model)["xyz"]
    chain = jax_trainer.make_rgb_optimizer(_opt_params(), 1.0, 3).groups[
        "xyz"]
    bare = optax.scale_by_adam(eps=1e-15)
    x = jnp.zeros((4, 3))
    state, bare_state = chain.init(x), bare.init(x)
    for u in range(5):
        grad = jnp.full_like(x, 1.0 + u)
        upd, state = chain.update(grad, state, x)
        step, bare_state = bare.update(grad, bare_state, x)
        xyz.grad = torch.full_like(xyz, 1.0 + u)
        set_scheduled_lrs(port_opt)
        assert xyz_group["lr"] == pytest.approx(
            -float(upd[0, 0]) / float(step[0, 0]), rel=1e-5)
        port_opt.step()
