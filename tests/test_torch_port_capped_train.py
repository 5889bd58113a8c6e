"""The port's budget-capped feature training against the JAX package: K5's
plain version against the Pallas kernel, the capped quick-train VJP, and
`train_features(tile_budget=...)` end to end.

JAX side as its own tests run it on the CPU: impl="pallas", Pallas kernels
(K1, K2, K5, K6) in interpret mode. Port side: device="cpu", so every
kernel wrapper runs its plain version.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.models.gaussians import GaussianModel as JaxModel
from langsplatv2_tpu.ops import pallas_blend, projection as jax_projection
from langsplatv2_tpu.ops.pallas_train import feature_grads_topk_pallas
from langsplatv2_tpu.ops.rasterize import RasterizeSettings as JaxSettings
from langsplatv2_tpu.ops.rasterize import rasterize as jax_rasterize
from langsplatv2_tpu.scene.cameras import Camera as JaxCamera
from langsplatv2_tpu.train import trainer as jax_trainer
from langsplatv2_tpu.utils import sparse_codes as jax_codes
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.ops import blend, budget, expand
from langsplatv2_tpu_torch.ops import train as quick_train
from langsplatv2_tpu_torch.ops.projection import ProjectedGaussians
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings, rasterize
from langsplatv2_tpu_torch.scene.cameras import Camera
from langsplatv2_tpu_torch.train import trainer

from test_torch_port_train import MAX_ENTRIES, _fov, _train_scene
from torch_port_fixtures import camera, scene

H, W = 48, 64
K, TOPK = 64, 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def case():
    """TestQuickTrainVJP's scene (300 splats, 48x64), the JAX top-k pairs
    of random logits and a random image-layout cotangent."""
    sc = scene(300, seed=0)
    view, pm, tfx, tfy = camera(H, W)
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(300, K)).astype(np.float32)
    qw, qi = jax_codes.get_weights_and_indices(jnp.asarray(logits), TOPK)
    return dict(sc=sc, view=view, pm=pm, tfx=tfx, tfy=tfy,
                qw=np.asarray(qw), qi=np.asarray(qi).astype(np.int32),
                cot=rng.normal(size=(K, H, W)).astype(np.float32),
                cot_tiles=rng.normal(size=(12, 256, K)).astype(np.float32))


# ------------------------------------------------------------------- K5

@pytest.mark.parametrize("t_budget,cap", [(1e-6, 128), (1e-300, 256)])
def test_feature_grads_topk_plain_matches_pallas(case, t_budget, cap):
    """K5's plain version against feature_grads_topk_pallas (interpret
    mode) on the same windows, kept counts and cotangent, within 1e-5 of
    the largest output: the port's weights are K2's running product, the
    Pallas kernel's an exclusive cumprod across lanes. Slots at or past
    kept[t] are 0 in both."""
    c, sc = case, case["sc"]
    proj_j = jax_projection.preprocess(
        jnp.asarray(sc["means"]), jnp.asarray(sc["scales"]),
        jnp.asarray(sc["rotations"]), None, None, jnp.asarray(sc["colors"]),
        jnp.asarray(c["view"]), jnp.asarray(c["pm"]),
        jnp.zeros(3, jnp.float32), c["tfx"], c["tfy"], W, H, 0, 1.0,
        opacities=jnp.asarray(sc["opacities"][:, 0]))
    proj = ProjectedGaussians(*[None if a is None else _t(np.array(a))
                                for a in proj_j])
    ops = _t(sc["opacities"][:, 0])
    gx, gy = 4, 3
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, gx, gy, 2 ** 12)
    g, start, count = expand.sort_entries(tile, depth, gauss, gx * gy)
    g_win = budget.slice_windows(g, start, cap).reshape(-1)
    gl = g_win.long()
    kept, _ = budget.budget_from_rows(proj.xy[gl], proj.conic[gl], ops[gl],
                                      count, gx, cap, 2, t_budget)
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, ops, proj.rgb)
    qi, cot = _t(c["qi"]), _t(c["cot_tiles"])
    out = quick_train.feature_grads_topk(g_win, kept, geom, qi, cot, gx, gy,
                                         cap)

    rows = pallas_blend.pack_quick_train_rows(
        proj_j.xy, proj_j.conic, jnp.asarray(sc["opacities"][:, 0]),
        proj_j.rgb, jnp.asarray(c["qw"]),
        jnp.asarray(c["qi"], jnp.float32))[jnp.asarray(g_win.numpy())]
    ref = feature_grads_topk_pallas(
        pallas_blend.to_field_major(rows, cap), jnp.asarray(kept.numpy()),
        jnp.arange(gx * gy, dtype=jnp.int32), jnp.asarray(c["cot_tiles"]),
        grid_x=gx, grid_y=gy, feat_k=K, topk=TOPK, cap=cap, interpret=True)
    ref = np.asarray(ref)[:TOPK, :gx * gy * cap].T
    scale = float(np.abs(ref).max())
    assert scale > 1e-2
    np.testing.assert_allclose(out.numpy() / scale, ref / scale, atol=1e-5)
    dead = (torch.arange(cap)[None, :] >= kept[:, None]).reshape(-1)
    assert bool(dead.any()) and float(out[dead].abs().max()) == 0.0


# -------------------------------------------------------- the capped VJP

def _jax_capped(c, t_budget, cap):
    sc = c["sc"]
    st = JaxSettings(image_height=H, image_width=W, tanfovx=c["tfx"],
                     tanfovy=c["tfy"], sh_degree=0, max_entries=2 ** 12,
                     tile_cap=256, tile_batch=4, impl="pallas",
                     tile_budget=t_budget, tile_budget_cap=cap)

    def loss(qw):
        out = jax_rasterize(
            st, jnp.asarray(sc["means"]), jnp.asarray(sc["opacities"]),
            jnp.asarray(c["view"]), jnp.asarray(c["pm"]),
            jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
            scales=jnp.asarray(sc["scales"]),
            rotations=jnp.asarray(sc["rotations"]),
            colors_precomp=jnp.asarray(sc["colors"]), quick_weights=qw,
            quick_indices=jnp.asarray(c["qi"]), quick_channels=K,
            quick_train=True)
        return jnp.sum(out.feature_map * jnp.asarray(c["cot"])), (
            out.live_total, out.max_tile_count, out.total_entries)
    (v, aux), g = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(c["qw"]))
    return float(v), np.asarray(g), [int(a) for a in aux]


def _port_capped(c, t_budget, cap, qw=None):
    sc = c["sc"]
    st = RasterizeSettings(H, W, c["tfx"], c["tfy"], 0, max_entries=2 ** 12,
                           tile_cap=256, tile_budget=t_budget,
                           tile_budget_cap=cap)
    qw = _t(c["qw"] if qw is None else qw).requires_grad_(True)
    out = rasterize(st, sc["means"], sc["opacities"], c["view"], c["pm"],
                    np.zeros(3, np.float32), np.zeros(3, np.float32),
                    scales=sc["scales"], rotations=sc["rotations"],
                    colors_precomp=sc["colors"], quick_weights=qw,
                    quick_indices=c["qi"], quick_channels=K,
                    quick_train=True, device="cpu")
    loss = (out.feature_map * _t(c["cot"])).sum()
    loss.backward()
    return float(loss.detach()), qw.grad.numpy(), out


@pytest.mark.parametrize("t_budget,cap", [(1e-300, 256), (1e-6, 128)])
def test_capped_vjp_matches_jax(case, t_budget, cap):
    """test_capped_mode_grads's scene: value rtol 1e-5 and d(quick_weights)
    atol 3e-5 (TestQuickTrainVJP's tolerances: K2's running product
    against the Pallas log-sum transmittance), and the kept total, the
    saturation bound and the expansion total equal JAX's."""
    v_j, g_j, aux_j = _jax_capped(case, t_budget, cap)
    v_p, g_p, out = _port_capped(case, t_budget, cap)
    assert [int(out.live_total), int(out.max_tile_count),
            int(out.total_entries)] == aux_j
    np.testing.assert_allclose(v_p, v_j, rtol=1e-5)
    np.testing.assert_allclose(g_p, g_j, atol=3e-5)
    assert float(np.abs(g_p).max()) > 1e-2
    _, _, exact = _port_capped(case, 0.0, 128)
    if t_budget > 1e-300:
        assert int(out.live_total) < int(exact.live_total)
    else:
        assert int(out.live_total) == int(exact.live_total)


def test_wide_codes_take_the_exact_route(case):
    """At a top-k width above 4 the JAX package runs the exact route
    whatever the budget (pallas_train.py:609-610); so does the port."""
    assert quick_train.capped_fits(4) and not quick_train.capped_fits(8)
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(300, K)).astype(np.float32)
    qw8, qi8 = jax_codes.get_weights_and_indices(jnp.asarray(logits), 8)
    c = dict(case, qi=np.asarray(qi8).astype(np.int32))
    v_b, g_b, with_budget = _port_capped(c, 1e-6, 128, np.asarray(qw8))
    v_0, g_0, exact = _port_capped(c, 0.0, 128, np.asarray(qw8))
    assert v_b == v_0 and np.array_equal(g_b, g_0)
    assert int(with_budget.live_total) == int(exact.live_total)


# ---------------------------------------------------- train_features, whole

def _record(module, monkeypatch, log):
    """Wrap module.make_feature_train_step so that each step call logs the
    expansion budget (max_entries) of its settings."""
    orig = module.make_feature_train_step

    def make(settings, *a, **kw):
        step = orig(settings, *a, **kw)

        def call(*args, **kwargs):
            log.append(settings.max_entries)
            return step(*args, **kwargs)
        return call
    monkeypatch.setattr(module, "make_feature_train_step", make)


def _train_both(tmp, poses, iterations):
    """Capped train_features (tile_budget 1e-6, cap 128) in both packages
    on test_torch_port_train.py's scene: 30k splats at 48x64, camera B (a
    half turn) sees 88,920 entries, camera A 22,293."""
    f = _train_scene(tmp)
    fovx, fovy = _fov()
    opt = types.SimpleNamespace(language_feature_lr=0.0025)
    kw = dict(iterations=iterations, seed=0, max_entries=MAX_ENTRIES,
              tile_budget=1e-6, tile_budget_cap=128)
    res = dict(f=f, jax_log=[], port_log=[], jax_metrics=[],
               port_metrics=[])

    def keep(name):
        return lambda _it, _m, _o, metrics: res[name].append(
            {k: int(metrics[k]) for k in ("live_total", "total_entries")})

    with pytest.MonkeyPatch.context() as mp:
        _record(jax_trainer, mp, res["jax_log"])
        jm = JaxModel(**{k: jnp.asarray(v) for k, v in f.items()},
                      active_sh_degree=0, max_sh_degree=0)
        jcams = [JaxCamera(i, R, np.zeros(3), fovx, fovy, None, f"c{i}", i,
                           W, H) for i, R in enumerate(poses)]
        res["jm"], _, res["jlogs"] = jax_trainer.train_features(
            jm, jcams, opt, str(tmp), 1, impl="pallas",
            on_iteration=keep("jax_metrics"), **kw)
        _record(trainer, mp, res["port_log"])
        model = from_numpy_params(f, device="cpu")
        cams = [Camera(i, R, np.zeros(3), fovx, fovy, None, f"c{i}", i, W, H)
                for i, R in enumerate(poses)]
        res["model"], _, res["logs"] = trainer.train_features(
            model, cams, opt, str(tmp), 1, device="cpu",
            on_iteration=keep("port_metrics"), **kw)
    return res


A_POSE, B_POSE = np.eye(3), np.diag([-1.0, 1.0, -1.0])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Cameras ordered [A, B]: B is drawn first, so the expansion budget
    is sized from the larger camera and A fits it."""
    return _train_both(tmp_path_factory.mktemp("capped"), [A_POSE, B_POSE], 3)


def test_capped_train_losses_and_budgets_match_jax(trained):
    np.testing.assert_allclose(trained["logs"].losses,
                               trained["jlogs"].losses, rtol=1e-5)
    assert len(trained["logs"].losses) == 3
    # The first step runs at max_entries, the rest at the sized budget.
    assert trained["port_log"] == trained["jax_log"] == [
        MAX_ENTRIES, 196608, 196608], trained["port_log"]
    assert list(trained["logs"].exp_budget.values()) == [196608]
    assert trained["logs"].live_budget == {}
    assert trained["port_metrics"] == trained["jax_metrics"]
    # The budget really cuts: far fewer entries blend than survive the cull.
    assert trained["port_metrics"][0]["live_total"] < 5000


def test_capped_train_final_logits_match_jax(trained):
    """Logits and codebooks after 3 Adam steps, atol 1e-5; dead rows never
    move."""
    f, jm, model = trained["f"], trained["jm"], trained["model"]
    for k in trainer.FEATURE_PARAM_NAMES:
        mine = getattr(model, k).detach().numpy()
        ref = np.asarray(getattr(jm, k))
        np.testing.assert_allclose(mine, ref, rtol=0, atol=1e-5, err_msg=k)
    assert not model.language_logits.grad[-100:].any()


def test_overflowing_camera_is_redone_where_jax_truncates(tmp_path):
    """Cameras [B, A]: A is drawn first and sizes the expansion budget to
    65,536; B then expands 88,920 entries. The JAX trainer's total is
    clamped to its budget and accepted at equality (trainer.py:1033), so
    its B step blends a truncated list. The port redoes B's step with a
    grown budget (ROADMAP.md Queue 3)."""
    res = _train_both(tmp_path, [B_POSE, A_POSE], 2)
    assert res["jax_log"] == [MAX_ENTRIES, 65536]
    assert res["jax_metrics"][1]["total_entries"] == 65536      # truncated
    assert res["port_log"] == [MAX_ENTRIES, 65536, 131072]      # redone
    assert list(res["logs"].exp_budget.values()) == [131072]
    assert res["port_metrics"][1]["total_entries"] == 88920
    np.testing.assert_allclose(res["logs"].losses[0],
                               res["jlogs"].losses[0], rtol=1e-5)


def test_wide_codes_train_without_budgets(tmp_path):
    """train_features at top-8 with a budget: the exact route with neither
    the live nor the expansion budget (as JAX, whose telemetry is off
    there), the same losses as without the budget."""
    f = _train_scene(tmp_path)
    fovx, fovy = _fov()
    opt = types.SimpleNamespace(language_feature_lr=0.0025)
    cams = [Camera(i, R, np.zeros(3), fovx, fovy, None, f"c{i}", i, W, H)
            for i, R in enumerate([A_POSE, B_POSE])]
    runs = []
    for t_budget in (1e-6, 0.0):
        model = from_numpy_params(f, device="cpu")
        runs.append(trainer.train_features(
            model, cams, opt, str(tmp_path), 1, iterations=2, seed=0,
            topk=8, max_entries=MAX_ENTRIES, tile_budget=t_budget,
            device="cpu")[2])
    assert runs[0].exp_budget == {} and runs[0].live_budget == {}
    assert runs[1].live_budget != {}
    np.testing.assert_allclose(runs[0].losses, runs[1].losses, rtol=1e-6)
