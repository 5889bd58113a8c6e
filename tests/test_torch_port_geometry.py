"""The port's geometry-phase modules against the JAX package: K7 (the RGB
backward) and the RGB-mode VJP, the losses, the learning-rate schedule,
the 3-NN scale init, the model's densification, and PLY / checkpoint
files across the packages.

JAX side as its own tests run it on the CPU: K7 and the RGB VJP in Pallas
interpret mode. Port side: device="cpu", so every kernel wrapper runs its
plain version.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.models import gaussians as jax_gm
from langsplatv2_tpu.models import io as jax_io
from langsplatv2_tpu.ops import pallas_blend, pallas_rgb_train
from langsplatv2_tpu.ops.knn import mean_sq_dist_3nn as jax_knn
from langsplatv2_tpu.ops.rasterize import RasterizeSettings as JaxSettings
from langsplatv2_tpu.ops.rasterize import rasterize as jax_rasterize
from langsplatv2_tpu.train import trainer as jax_trainer
from langsplatv2_tpu.utils import losses as jax_losses
from langsplatv2_tpu.utils import schedules as jax_schedules
from langsplatv2_tpu.utils.transforms import inverse_sigmoid as jax_inv_sigmoid
from langsplatv2_tpu_torch.models import gaussians as gm
from langsplatv2_tpu_torch.models import io
from langsplatv2_tpu_torch.ops import blend, expand, projection, rgb_train
from langsplatv2_tpu_torch.ops.knn import mean_sq_dist_3nn
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings, rasterize
from langsplatv2_tpu_torch.train import trainer
from langsplatv2_tpu_torch.utils import losses
from langsplatv2_tpu_torch.utils.schedules import expon_lr_func

from torch_port_fixtures import camera, scene

H, W = 48, 64
GX, GY = 4, 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _close_scaled(port, ref, atol, floor=1e-3, msg=""):
    """|port - ref| / max(floor, max|ref|) <= atol (TestRGBCustomVJP's
    normalization)."""
    scale = max(floor, float(np.abs(ref).max()))
    np.testing.assert_allclose(np.asarray(port) / scale,
                               np.asarray(ref) / scale, atol=atol,
                               err_msg=msg)


# ---------------------------------------------------------------- K7 rows

def test_rgb_grads_match_pallas_kernel():
    """Per-entry rows of the plain K7 against rgb_grads_pallas (interpret)
    on the same binning and pack, within 1e-5 of the largest row entry:
    the Pallas kernel carries T as exp(sum log1p(-alpha)) and keeps adding
    rounding-noise terms after a pixel ends, where the port stops."""
    sc = scene(300, seed=0)
    view, pm, tfx, tfy = camera(H, W)
    ops = _t(sc["opacities"][:, 0])
    proj = projection.preprocess(
        _t(sc["means"]), _t(sc["scales"]), _t(sc["rotations"]), None,
        _t(sc["colors"]), _t(view), _t(pm), torch.zeros(3), tfx, tfy, W, H,
        0, opacities=ops)
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, GX, GY, 2 ** 12)
    g, start, count = expand.sort_entries(tile, depth, gauss, GX * GY)
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, ops, proj.rgb)
    rgb_t, _, t_t = blend.blend_tiles_plain(g, start, count, geom,
                                            torch.zeros(3), GX)
    rng = np.random.default_rng(1)
    g_rgb = _t(rng.normal(size=(12, 256, 3)).astype(np.float32))
    g_t = _t(rng.normal(size=(12, 256)).astype(np.float32))
    pack = rgb_train.make_pack(rgb_t, t_t, g_rgb, g_t)
    rows = rgb_train.rgb_grads(g, start, count, geom, pack, GX, GY)
    # The Pallas kernel's pack (pallas_rgb_train.py:366-370): gT and
    # T_final apart, two pad columns.
    jpack = torch.cat([pack[..., :4], g_t[..., None], t_t[..., None],
                       torch.zeros(12, 256, 2)], dim=-1)
    n = int(count.sum())
    assert rows.shape == (n, 9) and n > 500

    jrows = pallas_blend.pack_gaussian_rows(
        jnp.asarray(proj.xy.numpy()), jnp.asarray(proj.conic.numpy()),
        jnp.asarray(ops.numpy()), jnp.asarray(proj.rgb.numpy()))
    entry_geom = pallas_blend.to_field_major(jrows[jnp.asarray(g.numpy())],
                                             256)
    ref = pallas_rgb_train.rgb_grads_pallas(
        entry_geom, jnp.asarray(start.numpy()), jnp.asarray(count.numpy()),
        jnp.arange(GX * GY, dtype=jnp.int32), jnp.asarray(jpack.numpy()),
        grid_x=GX, grid_y=GY, interpret=True)
    ref = np.asarray(ref)[:n, :9]
    scale = float(np.abs(ref).max())
    assert scale > 1.0
    np.testing.assert_allclose(rows.numpy() / scale, ref / scale, atol=1e-5)


# ------------------------------------------------------- the RGB-mode VJP

def _vjp_case(sh: bool):
    """TestRGBCustomVJP's scene (300 splats, 48x64, bg != 0, random
    cotangents on the image and the final transmittance); with `sh`, SH
    degree 3 coefficients and an off-centre camera in place of colours."""
    sc = scene(300, seed=0)
    rng = np.random.default_rng(1)
    case = dict(sc=sc, cot_rgb=rng.normal(size=(3, H, W)).astype(np.float32),
                cot_t=rng.normal(size=(H, W)).astype(np.float32),
                bg=np.array([0.3, 0.1, 0.2], np.float32),
                campos=np.zeros(3, np.float32), degree=0)
    if sh:
        case.update(
            shs=(0.3 * rng.normal(size=(300, 16, 3))).astype(np.float32),
            campos=np.array([0.2, -0.1, -0.3], np.float32), degree=3)
    return case


def _jax_vjp(c):
    view, pm, tfx, tfy = camera(H, W)
    st = JaxSettings(image_height=H, image_width=W, tanfovx=tfx,
                     tanfovy=tfy, sh_degree=c["degree"], max_entries=2 ** 12,
                     impl="pallas")
    sc = c["sc"]
    colour_name = "shs" if "shs" in c else "colors_precomp"
    colour = c["shs"] if "shs" in c else sc["colors"]

    def loss(means3d, op, scales, rots, col, dummy):
        out = jax_rasterize(
            st, means3d, op, jnp.asarray(view), jnp.asarray(pm),
            jnp.asarray(c["campos"]), jnp.asarray(c["bg"]), scales=scales,
            rotations=rots, means2d_dummy=dummy, **{colour_name: col})
        return (jnp.sum(out.rgb * c["cot_rgb"])
                + jnp.sum(out.final_transmittance * c["cot_t"]))

    args = [jnp.asarray(a) for a in (sc["means"], sc["opacities"],
                                     sc["scales"], sc["rotations"], colour,
                                     np.zeros((300, 2), np.float32))]
    v, g = jax.value_and_grad(loss, argnums=tuple(range(6)))(*args)
    return float(v), [np.asarray(x) for x in g]


def _port_vjp(c):
    view, pm, tfx, tfy = camera(H, W)
    st = RasterizeSettings(H, W, tfx, tfy, c["degree"], max_entries=2 ** 12)
    sc = c["sc"]
    colour = c["shs"] if "shs" in c else sc["colors"]
    leaves = [_t(a).requires_grad_(True) for a in (
        sc["means"], sc["opacities"], sc["scales"], sc["rotations"], colour,
        np.zeros((300, 2), np.float32))]
    colour_kw = {"shs" if "shs" in c else "colors_precomp": leaves[4]}
    out = rasterize(st, leaves[0], leaves[1], view, pm, c["campos"], c["bg"],
                    scales=leaves[2], rotations=leaves[3],
                    means2d_dummy=leaves[5], device="cpu", **colour_kw)
    loss = ((out.rgb * _t(c["cot_rgb"])).sum()
            + (out.final_transmittance * _t(c["cot_t"])).sum())
    loss.backward()
    return float(loss.detach()), [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("sh", [False, True], ids=["colors", "sh3"])
def test_rgb_vjp_matches_jax(sh):
    """Value at rtol 1e-4 and d(means3d, opacity, scales, rotations,
    colours, means2D carrier) scale-normalized at atol 5e-5: the tolerances
    of TestRGBCustomVJP, which pins the JAX Pallas VJP to XLA autodiff the
    same way (T as a running product here, exp(sum log1p) there; another
    summation order for the per-Gaussian sums)."""
    c = _vjp_case(sh)
    v_j, g_j = _jax_vjp(c)
    v_p, g_p = _port_vjp(c)
    np.testing.assert_allclose(v_p, v_j, rtol=1e-4)
    names = ("means3d", "opacity", "scales", "rotations", "colour",
             "means2d")
    for nm, gp, gj in zip(names, g_p, g_j):
        assert np.isfinite(gp).all(), nm
        assert float(np.abs(gj).max()) > 1e-3, nm     # not zeros vs zeros
        _close_scaled(gp, gj, 5e-5, msg=nm)


def test_rgb_blend_backward_matches_autograd_of_plain_blend():
    """RGBTrainBlend's backward (plain K7, index_add_) against torch
    autograd straight through blend_tiles_plain (bg = 0): the K7 formula
    is the exact gradient of the replayed blend, up to summation order
    (1e-6 of the largest entry)."""
    sc = scene(300, seed=3)
    view, pm, tfx, tfy = camera(H, W)
    ops = _t(sc["opacities"][:, 0])
    proj = projection.preprocess(
        _t(sc["means"]), _t(sc["scales"]), _t(sc["rotations"]), None,
        _t(sc["colors"]), _t(view), _t(pm), torch.zeros(3), tfx, tfy, W, H,
        0, opacities=ops)
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, GX, GY, 2 ** 12)
    g, start, count = expand.sort_entries(tile, depth, gauss, GX * GY)
    gen = torch.Generator().manual_seed(2)
    g_rgb = torch.randn(12, 256, 3, generator=gen)
    g_t = torch.randn(12, 256, generator=gen)
    fields = (proj.xy, proj.conic, ops, proj.rgb)
    a = [f.detach().clone().requires_grad_(True) for f in fields]
    rgb_a, t_a = rgb_train.RGBTrainBlend.apply(*a, g, start, count, GX, GY)
    ((rgb_a * g_rgb).sum() + (t_a * g_t).sum()).backward()
    b = [f.detach().clone().requires_grad_(True) for f in fields]
    rgb_b, _, t_b = blend.blend_tiles_plain(
        g, start, count, blend.pack_gaussian_state(*b), torch.zeros(3), GX)
    ((rgb_b * g_rgb).sum() + (t_b * g_t).sum()).backward()
    assert torch.equal(rgb_a, rgb_b) and torch.equal(t_a, t_b)
    for x, y in zip(a, b):
        scale = float(y.grad.abs().max())
        assert scale > 0
        torch.testing.assert_close(x.grad / scale, y.grad / scale, atol=1e-6,
                                   rtol=0)


# ------------------------------------------------- losses, lr, 3-NN scale

def test_l1_and_ssim_match_jax():
    """Values at rtol 1e-5 and gradients at 1e-5 of the largest: the 11x11
    window sums run in another order, and SSIM's variances (E[x^2] -
    E[x]^2) cancel, which lifts the relative error of its mean to ~3e-6."""
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (3, 37, 53)).astype(np.float32)
    b = rng.uniform(0, 1, (3, 37, 53)).astype(np.float32)
    for jfn, pfn in ((jax_losses.l1_loss, losses.l1_loss),
                     (jax_losses.ssim, losses.ssim)):
        v_j, g_j = jax.value_and_grad(jfn)(jnp.asarray(a), jnp.asarray(b))
        x = _t(a).requires_grad_(True)
        v_p = pfn(x, _t(b))
        v_p.backward()
        np.testing.assert_allclose(float(v_p.detach()), float(v_j),
                                   rtol=1e-5)
        _close_scaled(x.grad.numpy(), np.asarray(g_j), 1e-5, floor=0.0)
    batch = np.stack([a, b])
    np.testing.assert_allclose(
        losses.ssim(_t(batch), _t(batch[::-1].copy()),
                    size_average=False).numpy(),
        np.asarray(jax_losses.ssim(jnp.asarray(batch),
                                   jnp.asarray(batch[::-1]),
                                   size_average=False)), rtol=1e-5)
    np.testing.assert_allclose(
        losses.psnr(_t(a)[None], _t(b)[None]).numpy(),
        np.asarray(jax_losses.psnr(jnp.asarray(a)[None],
                                   jnp.asarray(b)[None])), rtol=1e-6)


@pytest.mark.parametrize("delay", [0, 500])
def test_expon_lr_func_matches_jax(delay):
    kw = dict(lr_init=0.00016, lr_final=0.0000016, lr_delay_steps=delay,
              lr_delay_mult=0.01, max_steps=30_000)
    mine, ref = expon_lr_func(**kw), jax_schedules.expon_lr_func(**kw)
    # The JAX schedule evaluates in float32: the exponent's rounding moves
    # the rate by ~1e-6 of itself.
    for step in (-1, 0, 1, 7, 250, 1000, 29_999, 30_000, 45_000):
        np.testing.assert_allclose(mine(step), float(ref(step)), rtol=5e-6,
                                   err_msg=str(step))
    assert expon_lr_func(0.0, 0.0)(10) == 0.0


@pytest.mark.parametrize("n", [200, 2050], ids=["one-chunk", "two-chunks"])
def test_mean_sq_dist_3nn_matches_jax(n):
    """rtol 1e-5 plus atol 2e-6: both packages expand |a - b|^2 as |a|^2 -
    2 a.b + |b|^2, whose terms (~3 for these points) cancel, so the
    products' rounding (a few 1e-7 of them, summed in another order)
    stays in the distance."""
    pts = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    got = mean_sq_dist_3nn(_t(pts)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_knn(jnp.asarray(pts))),
                               rtol=1e-5, atol=2e-6)
    d2 = ((pts[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    np.testing.assert_allclose(got, np.sort(d2, axis=1)[:, :3].mean(1),
                               rtol=1e-4)


# ------------------------------------------------------ model, densify

def _jax_fields(m) -> dict:
    return {k: np.asarray(getattr(m, k)) for k in jax_io.MODEL_FIELDS
            if getattr(m, k) is not None}


def _port_model(jm):
    return gm.from_numpy_params(
        _jax_fields(jm), active_sh_degree=jm.active_sh_degree,
        max_sh_degree=jm.max_sh_degree,
        spatial_lr_scale=jm.spatial_lr_scale, device="cpu")


def _assert_same_model(m, jm, close=()):
    """Fields equal, those in `close` at rtol 1e-6."""
    for name, ref in _jax_fields(jm).items():
        mine = getattr(m, name).detach().numpy()
        assert mine.shape == ref.shape, name
        if name in close:
            np.testing.assert_allclose(mine, ref, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(mine, ref, err_msg=name)
    assert (m.active_sh_degree, m.max_sh_degree) == (jm.active_sh_degree,
                                                     jm.max_sh_degree)


def test_create_from_pcd_matches_jax():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.uniform(size=(50, 3)).astype(np.float32)
    jm = jax_gm.create_from_pcd(pts, cols, 1.5, capacity=64)
    dist2 = np.asarray(jax_knn(jnp.asarray(pts)))
    m = gm.create_from_pcd(pts, cols, 1.5, capacity=64, device="cpu",
                           knn_mean_sq_dist=dist2)
    _assert_same_model(m, jm, close=("scaling",))   # log, sqrt: last bit
    # With its own 3-NN, the log-scales differ by the distances' rounding
    # (see test_mean_sq_dist_3nn_matches_jax).
    own = gm.create_from_pcd(pts, cols, 1.5, capacity=64, device="cpu")
    np.testing.assert_allclose(own.scaling.detach().numpy(),
                               np.asarray(jm.scaling), rtol=0, atol=2e-5)
    assert m.spatial_lr_scale == 1.5 and int(m.num_live) == 50
    np.testing.assert_array_equal(m.rotation[50:].numpy(),
                                  np.tile([1.0, 0, 0, 0], (14, 1)))
    m.one_up_sh_degree()
    assert m.active_sh_degree == 1


def _densify_case(kind, rng):
    """TestDensify's three cases: (JAX model, max_grad)."""
    if kind == "overflow":
        n = cap = 10
    else:
        n, cap = (20, 64) if kind == "clone-split" else (10, 16)
    m = jax_gm.create_from_pcd(rng.normal(size=(n, 3)).astype(np.float32),
                               rng.uniform(size=(n, 3)).astype(np.float32),
                               1.0, capacity=cap)
    if kind == "clone-split":
        accum = np.zeros((cap, 1), np.float32)
        accum[:5] = 10.0
        denom = np.zeros((cap, 1), np.float32)
        denom[:5] = 1.0
        scaling = np.asarray(m.scaling).copy()
        scaling[2:5] = np.log(5.0)
        scaling[:2] = np.log(0.001)
        m = m.replace(xyz_gradient_accum=jnp.asarray(accum),
                      denom=jnp.asarray(denom), scaling=jnp.asarray(scaling),
                      rotation=jnp.asarray(rng.normal(size=(cap, 4)),
                                           jnp.float32))
        return m, 1.0
    if kind == "prune":
        op = np.asarray(m.opacity).copy()
        op[:4] = np.asarray(jax_inv_sigmoid(jnp.asarray(0.001)))
        return m.replace(opacity=jnp.asarray(op)), 1e9
    return m.replace(xyz_gradient_accum=jnp.full((n, 1), 10.0),
                     denom=jnp.ones((n, 1)),
                     scaling=jnp.full((n, 3), np.log(0.001))), 1.0


@pytest.mark.parametrize("kind", ["clone-split", "prune", "overflow"])
@pytest.mark.parametrize("screen", [0.0, 20.0], ids=["no-ws", "ws-prune"])
def test_densify_and_prune_matches_jax(kind, screen):
    """Same fields, overflow and placed slots given the same split noise
    (drawn from the JAX key and handed over); after an overflow, the
    grown model's round matches too."""
    jm, max_grad = _densify_case(kind, np.random.default_rng(6))
    key = jax.random.PRNGKey(0)
    kw = dict(max_grad=max_grad, min_opacity=0.005, extent=1.0,
              max_screen_size=screen, percent_dense=0.01)
    for grow in (False, True):
        if grow:
            jm = jax_gm.grow_capacity(jm, 32)
        m = _port_model(jm)
        j2, j_over, j_placed = jax_gm.densify_and_prune(jm, key, **kw)
        eps = np.asarray(jax.random.normal(key, (2, jm.capacity, 3)))
        m2, over, placed = gm.densify_and_prune(m, _t(eps), **kw)
        assert int(over) == int(j_over)
        np.testing.assert_array_equal(placed.numpy(), np.asarray(j_placed))
        # Split children's xyz: R (eps * s) summed in another order.
        _assert_same_model(m2, j2, close=("xyz",))
        if kind != "overflow":
            break
    if kind == "clone-split" and screen == 0:
        assert int(m2.num_live) == 25     # 20 - 3 split + 2 clones + 6
    if kind == "overflow":
        assert int(over) == 0 and int(m2.num_live) == 20
        assert m2.capacity == 32


def test_reset_opacity_grow_and_compact_match_jax():
    rng = np.random.default_rng(7)
    jm = jax_gm.create_from_pcd(rng.normal(size=(12, 3)).astype(np.float32),
                                rng.uniform(size=(12, 3)).astype(np.float32),
                                1.0, capacity=16)
    jm = jm.replace(opacity=jnp.asarray(
        rng.uniform(-8, 3, (16, 1)).astype(np.float32)))
    m = _port_model(jm)
    # (reset_opacity donates its argument.) The sigmoid is written out in
    # the port, jax.nn.sigmoid in JAX: opacities below 0.01 keep a
    # rounding difference.
    reset = jax_gm.reset_opacity(jax.tree_util.tree_map(jnp.copy, jm))
    _assert_same_model(gm.reset_opacity(m), reset, close=("opacity",))
    grown, jgrown = gm.grow_capacity(m, 40), jax_gm.grow_capacity(jm, 40)
    _assert_same_model(grown, jgrown)
    _assert_same_model(gm.compact(grown), jax_gm.compact(jgrown))


# ------------------------------------------------ files across packages

def _trained_jax_model_and_state():
    """A JAX model with densification statistics and an RGB optimizer
    state after one update (non-zero moments and counts)."""
    rng = np.random.default_rng(8)
    jm = jax_gm.create_from_pcd(rng.normal(size=(30, 3)).astype(np.float32),
                                rng.uniform(size=(30, 3)).astype(np.float32),
                                2.0, capacity=32)
    jm = jm.replace(denom=jnp.asarray(rng.integers(0, 5, (32, 1)),
                                      jnp.float32),
                    max_radii2d=jnp.asarray(rng.uniform(0, 9, 32),
                                            jnp.float32))
    opt = types_opt()
    optimizer = jax_trainer.make_rgb_optimizer(opt, jm.spatial_lr_scale)
    params = jax_trainer.rgb_params(jm)
    state = optimizer.init(params)
    grads = {k: jnp.asarray(rng.normal(size=v.shape), jnp.float32)
             for k, v in params.items()}
    new_params, state = optimizer.update(grads, state, params)
    return jm.replace(**new_params), optimizer, state


def types_opt():
    import types
    return types.SimpleNamespace(
        position_lr_init=0.00016, position_lr_final=0.0000016,
        position_lr_delay_mult=0.01, position_lr_max_steps=30_000,
        feature_lr=0.0025, opacity_lr=0.05, scaling_lr=0.005,
        rotation_lr=0.001)


def test_checkpoints_round_trip_across_packages(tmp_path):
    """JAX checkpoint -> the port (model, stats, Adam state); the port's
    checkpoint -> JAX load_checkpoint with make_rgb_optimizer's template,
    leaf for leaf."""
    jm, optimizer, state = _trained_jax_model_and_state()
    path = str(tmp_path / "jax.npz")
    jax_io.save_checkpoint(path, jm, state, 77)
    m, it = io.load_checkpoint(path, device="cpu")
    assert it == 77
    _assert_same_model(m, jm)
    port_opt = trainer.make_rgb_optimizer(types_opt(), m)
    io.load_optimizer_state(path, port_opt)
    for g in port_opt.param_groups:
        st = port_opt.state[g["params"][0]]
        ref_adam = state[g["name"]][0]
        assert int(st["step"]) == int(ref_adam.count) == 1
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      np.asarray(ref_adam.mu))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(ref_adam.nu))

    out = str(tmp_path / "port.npz")
    io.save_checkpoint(out, m, port_opt, 78, extra={"phase": "rgb"})
    template = optimizer.init(jax_trainer.rgb_params(jm))
    jm2, state2, it2, extra = jax_io.load_checkpoint(out, jm, template)
    assert it2 == 78 and extra == {"phase": "rgb"}
    _assert_same_model(m, jm2)
    a, _ = jax.tree_util.tree_flatten(state)
    b, _ = jax.tree_util.tree_flatten(state2)
    assert len(a) == len(b) == 19
    for x, y in zip(a, b):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_ply_round_trips_across_packages(tmp_path):
    jm, _, _ = _trained_jax_model_and_state()
    jm = jm.replace(live=jm.live.at[3].set(False))
    p = str(tmp_path / "jax.ply")
    jax_io.save_ply(jm, p)
    m = io.load_ply(p, max_sh_degree=3, device="cpu")
    ref = jax_io.load_ply(p, max_sh_degree=3)
    for name in ("xyz", "features_dc", "features_rest", "scaling",
                 "rotation", "opacity", "live"):
        np.testing.assert_array_equal(getattr(m, name).detach().numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert m.capacity == 29 and m.active_sh_degree == 3
    q = str(tmp_path / "port.ply")
    io.save_ply(m, q)
    with open(p, "rb") as f, open(q, "rb") as g:
        assert f.read() == g.read()
    padded = io.load_ply(q, capacity=32, device="cpu")
    assert int(padded.num_live) == 29
    np.testing.assert_array_equal(padded.rotation[29:].numpy(),
                                  np.tile([1.0, 0, 0, 0], (3, 1)))


# ------------------------------------------------ optimizer state surgery

def test_optimizer_surgery_matches_jax():
    """zero_moment_rows, zero_group_moments and the state growth of a
    capacity change, on the same Adam state in both packages (one update
    from the same gradients)."""
    from langsplatv2_tpu.train import optimizers as jax_optimizers
    from langsplatv2_tpu_torch.train import optimizers

    jm, optimizer, state = _trained_jax_model_and_state()
    mask = np.zeros(32, bool)
    mask[[1, 5, 30]] = True
    ref = jax_optimizers.zero_moment_rows(state, jnp.asarray(mask))
    ref = jax_optimizers.zero_group_moments(ref, "opacity")
    ref = jax.tree_util.tree_map(
        lambda x: jax_trainer._grow_rows(x, 32, 48), ref)

    m = _port_model(jm)
    port_opt = trainer.make_rgb_optimizer(types_opt(), m)
    for g in port_opt.param_groups:
        (p,) = g["params"]
        adam = state[g["name"]][0]
        port_opt.state[p] = {"step": torch.tensor(1.0),
                             "exp_avg": _t(adam.mu).clone(),
                             "exp_avg_sq": _t(adam.nu).clone()}
    optimizers.zero_moment_rows(port_opt, _t(mask))
    optimizers.zero_group_moments(port_opt, "opacity")
    grown = gm.grow_capacity(m, 48)
    optimizers.rebind(port_opt, trainer.rgb_params(grown))
    for g in port_opt.param_groups:
        (p,) = g["params"]
        assert p is getattr(grown, g["name"])
        st = port_opt.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                      np.asarray(ref[g["name"]][0].mu))
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(),
                                      np.asarray(ref[g["name"]][0].nu))
        assert int(st["step"]) == 1
    with pytest.raises(KeyError):
        optimizers.zero_group_moments(port_opt, "language_logits")


class _Polled(Exception):
    pass


@pytest.mark.parametrize("option", ["gui_source_path"])
def test_train_rgb_later_options_raise(option, monkeypatch):
    """gui_source_path is ported: the loop polls the viewer at the top of
    its first iteration, before any step (the poll raises here to show
    it)."""
    m = gm.create_from_pcd(np.zeros((4, 3), np.float32) + np.arange(4)[:, None],
                           np.zeros((4, 3), np.float32), 1.0, device="cpu")

    def poll(model, bg, iteration, iterations, source, max_entries,
             tile_cap, dev):
        raise _Polled(iteration, iterations, source)

    monkeypatch.setattr(trainer, "_gui_poll", poll)
    with pytest.raises(_Polled) as e:
        trainer.train_rgb(m, [], types_opt(), 1.0, iterations=1,
                          device="cpu", **{option: "scene"})
    assert e.value.args == (1, 1, "scene")
