"""The port's feature-phase training slice against the JAX package: the
quick-train VJP (K2 forward, K4 backward), the fused Gram loss (K6a/K6b),
the sparse-code gradients, the camera loader, Adam, and `train_features`
end to end.

JAX side as its own tests run it on the CPU: impl="pallas" forces the
Pallas route, whose kernels (K1, K2, K4, K6) run in interpret mode.
Port side: device="cpu", so every kernel wrapper runs its plain version.
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from langsplatv2_tpu.models.gaussians import GaussianModel as JaxModel
from langsplatv2_tpu.models.renderer import render as jax_render
from langsplatv2_tpu.ops.pallas_gram import gram_loss_fused as jax_gram_fused
from langsplatv2_tpu.ops.rasterize import RasterizeSettings as JaxSettings
from langsplatv2_tpu.ops.rasterize import rasterize as jax_rasterize
from langsplatv2_tpu.scene.cameras import Camera as JaxCamera
from langsplatv2_tpu.train import optimizers as jax_optimizers
from langsplatv2_tpu.train import trainer as jax_trainer
from langsplatv2_tpu.utils import sparse_codes as jax_codes
from langsplatv2_tpu_torch.models.gaussians import (from_numpy_params,
                                                    init_language_features)
from langsplatv2_tpu_torch.ops import blend, expand, gram, projection
from langsplatv2_tpu_torch.ops import train as quick_train
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings, rasterize
from langsplatv2_tpu_torch.scene.cameras import Camera, resize_nearest
from langsplatv2_tpu_torch.train import trainer
from langsplatv2_tpu_torch.train.config import OptimizationParams
from langsplatv2_tpu_torch.train.optimizers import grouped_adam
from langsplatv2_tpu_torch.utils import sparse_codes

from torch_port_fixtures import camera, model_fields, scene

H, W = 48, 64
K, TOPK = 64, 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ K4 / quick VJP

@pytest.fixture(scope="module")
def vjp_case():
    """The TestQuickTrainVJP scene (300 splats, 48x64), the JAX top-k
    pairs of random logits, and a random cotangent."""
    sc = scene(300, seed=0)
    view, pm, tfx, tfy = camera(H, W)
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(300, K)).astype(np.float32)
    qw, qi = jax_codes.get_weights_and_indices(jnp.asarray(logits), TOPK)
    return dict(sc=sc, view=view, pm=pm, tfx=tfx, tfy=tfy,
                qw=np.asarray(qw), qi=np.asarray(qi).astype(np.int32),
                cot_img=rng.normal(size=(K, H, W)).astype(np.float32),
                cot_tiles=rng.normal(size=(12, 256, K)).astype(np.float32))


def _jax_quick_loss(c, live_entries, assemble):
    sc = c["sc"]
    st = JaxSettings(image_height=H, image_width=W, tanfovx=c["tfx"],
                     tanfovy=c["tfy"], sh_degree=0, max_entries=2 ** 12,
                     impl="pallas", live_entries=live_entries,
                     assemble=assemble)
    cot = jnp.asarray(c["cot_img"] if assemble else c["cot_tiles"])

    def loss(qw):
        out = jax_rasterize(
            st, jnp.asarray(sc["means"]), jnp.asarray(sc["opacities"]),
            jnp.asarray(c["view"]), jnp.asarray(c["pm"]),
            jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
            scales=jnp.asarray(sc["scales"]),
            rotations=jnp.asarray(sc["rotations"]),
            colors_precomp=jnp.asarray(sc["colors"]), quick_weights=qw,
            quick_indices=jnp.asarray(c["qi"], jnp.float32),
            quick_channels=K, quick_train=True)
        return jnp.sum(out.feature_map * cot)
    return jax.value_and_grad(loss)(jnp.asarray(c["qw"]))


def _port_quick(c, live_entries, assemble):
    sc = c["sc"]
    st = RasterizeSettings(H, W, c["tfx"], c["tfy"], 0, max_entries=2 ** 12,
                           live_entries=live_entries, assemble=assemble)
    qw = _t(c["qw"]).requires_grad_(True)
    out = rasterize(st, sc["means"], sc["opacities"], c["view"], c["pm"],
                    np.zeros(3, np.float32), np.zeros(3, np.float32),
                    scales=sc["scales"], rotations=sc["rotations"],
                    colors_precomp=sc["colors"], quick_weights=qw,
                    quick_indices=c["qi"], quick_channels=K,
                    quick_train=True, device="cpu")
    cot = _t(c["cot_img"] if assemble else c["cot_tiles"])
    loss = (out.feature_map * cot).sum()
    loss.backward()
    return float(loss), qw.grad.numpy(), out


@pytest.mark.parametrize("clamp,assemble", [(False, True), (True, True),
                                            (False, False)],
                         ids=["full", "live-prefix", "tiles"])
def test_quick_train_vjp_matches_jax(vjp_case, clamp, assemble):
    """Value and d(quick_weights) of sum(feature_map * cot), tolerances of
    TestQuickTrainVJP (rtol 1e-5, atol 3e-5): the port's W (K2's running
    product) and the Pallas W (exp of summed log1p) are allclose, not
    equal, and a pixel at exactly the 1e-4 threshold could end one entry
    apart."""
    live = 0
    if clamp:
        _, _, out = _port_quick(vjp_case, 0, True)
        live = -(-int(out.live_total) // 128) * 128
        assert live < 2 ** 12, "the scene must leave slack for the clamp"
    v_j, g_j = _jax_quick_loss(vjp_case, live, assemble)
    v_p, g_p, out = _port_quick(vjp_case, live, assemble)
    np.testing.assert_allclose(v_p, float(v_j), rtol=1e-5)
    np.testing.assert_allclose(g_p, np.asarray(g_j), atol=3e-5)
    assert float(np.abs(g_p).max()) > 1e-2       # not a comparison of zeros
    if not assemble:
        assert tuple(out.feature_map.shape) == (12, 256, K)


def test_quick_train_backward_matches_autograd_of_plain_blend(vjp_case):
    """The Function's backward (plain K4, projection, index_add_) against
    torch autograd straight through blend_tiles_plain: atol 1e-6 plus rtol
    1e-5, since the two sum each Gaussian's O(1) gradient over hundreds of
    (entry, pixel) terms in different orders (per entry over pixels, then
    over entries, against per pixel over entries)."""
    c, sc = vjp_case, vjp_case["sc"]
    ops = _t(sc["opacities"][:, 0])
    proj = projection.preprocess(
        _t(sc["means"]), _t(sc["scales"]), _t(sc["rotations"]), None,
        _t(sc["colors"]), _t(c["view"]), _t(c["pm"]), torch.zeros(3),
        c["tfx"], c["tfy"], W, H, 0, opacities=ops)
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, 4, 3, 2 ** 12)
    g, start, count = expand.sort_entries(tile, depth, gauss, 12)
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, ops, proj.rgb)
    qi = _t(c["qi"])
    cot = _t(c["cot_tiles"])
    qw_a = _t(c["qw"]).requires_grad_(True)
    feat = quick_train.QuickTrainBlend.apply(
        qw_a, g, start, count, geom, torch.zeros(3), qi, 4, 3, K)[1]
    (feat * cot).sum().backward()
    qw_b = _t(c["qw"]).requires_grad_(True)
    ref = blend.blend_tiles_plain(g, start, count, geom, torch.zeros(3), 4,
                                  qw_b, qi, K)[1]
    (ref * cot).sum().backward()
    torch.testing.assert_close(feat, ref, atol=0, rtol=0)
    torch.testing.assert_close(qw_a.grad, qw_b.grad, atol=1e-6, rtol=1e-5)
    # Rows of entries no tile blends (the dead tail) are zero.
    dfeat = quick_train.feature_grads(g, start, count, geom, cot, 4, 3)
    assert float(dfeat[int(count.sum()):].abs().max()) == 0.0


# ---------------------------------------------------------------- K6a / K6b

def _gram_case(rng, L, grid_x, grid_y, h, w, nseg, zero_frac=0.1):
    t = grid_x * grid_y
    wmap = rng.normal(size=(t, 256, L * K)).astype(np.float32)
    wmap[rng.uniform(size=(t, 256)) < zero_frac] = 0.0   # n2 == 0 exactly
    seg = rng.integers(0, nseg, (h, w)).astype(np.int32)
    seg[rng.uniform(size=(h, w)) < 0.05] = -1
    table = rng.normal(size=(nseg, 512)).astype(np.float32)
    codebooks = rng.normal(size=(L, K, 512)).astype(np.float32)
    return codebooks, wmap, table, seg


def _port_value_and_grads(fn, cb, wm, table, seg, lay, scale=1.0):
    cb_t = _t(cb).requires_grad_(True)
    wm_t = _t(wm).requires_grad_(True)
    loss = scale * fn(cb_t, wm_t, _t(table), _t(seg), lay)
    loss.backward()
    return float(loss), cb_t.grad.numpy(), wm_t.grad.numpy()


def _assert_gram_close(port, ref, atol):
    """Value at rtol 2e-6; gradients scale-normalized (uncovered pixels
    carry ~1/eps gradients, as in tests/test_gram_fused.py)."""
    np.testing.assert_allclose(port[0], ref[0], rtol=2e-6)
    sc = max(1e-6, float(np.abs(ref[1]).max()))
    np.testing.assert_allclose(port[1] / sc, ref[1] / sc, atol=atol)
    sw = max(1.0, float(np.abs(ref[2]).max()))
    np.testing.assert_allclose(port[2] / sw, ref[2] / sw, atol=atol)


@pytest.mark.parametrize("L,lay", [(1, 0), (2, 0), (2, 1), (3, 2)])
def test_gram_loss_matches_jax(L, lay):
    """Fused loss (K6a/K6b plain) and the XLA formulation of the port, each
    against the JAX fused loss in interpret mode and the JAX XLA core."""
    rng = np.random.default_rng(7 + L * 10 + lay)
    grid_x, grid_y, h, w = 5, 3, 41, 77             # ragged: padding tiles
    cb, wm, table, seg = _gram_case(rng, L, grid_x, grid_y, h, w, nseg=96)
    args = (jnp.asarray(table), jnp.asarray(seg))

    def jax_fused(p):
        return jax_gram_fused(p[0], p[1], *args, lay, grid_x, grid_y,
                              interpret=True)

    def jax_xla(p):
        return jax_trainer.gram_cos_loss_tiles(p[0], p[1], *args, lay)

    for ref_fn in (jax_fused, jax_xla):
        v, (g_cb, g_wm) = jax.value_and_grad(ref_fn)(
            (jnp.asarray(cb), jnp.asarray(wm)))
        ref = (float(v), np.asarray(g_cb), np.asarray(g_wm))
        for fn in (gram.gram_loss_fused, trainer.gram_cos_loss_tiles):
            _assert_gram_close(
                _port_value_and_grads(fn, cb, wm, table, seg, lay), ref,
                atol=5e-6)
    # Only layer `lay` of the map and codebook `lay` get a gradient.
    _, g_cb, g_wm = _port_value_and_grads(gram.gram_loss_fused, cb, wm,
                                          table, seg, lay)
    keep = np.zeros(L * K, bool)
    keep[lay * K:(lay + 1) * K] = True
    assert not g_wm[..., ~keep].any() and g_wm[..., keep].any()
    assert not np.delete(g_cb, lay, axis=0).any() and g_cb[lay].any()


def test_gram_loss_upstream_cotangent_matches_jax():
    """A non-unit cotangent scales all gradients linearly."""
    rng = np.random.default_rng(3)
    cb, wm, table, seg = _gram_case(rng, 1, 4, 2, 32, 64, nseg=64)

    def f(p):
        return 3.5 * jax_gram_fused(p[0], p[1], jnp.asarray(table),
                                    jnp.asarray(seg), 0, 4, 2,
                                    interpret=True)

    v, (g_cb, g_wm) = jax.value_and_grad(f)((jnp.asarray(cb),
                                             jnp.asarray(wm)))
    port = _port_value_and_grads(gram.gram_loss_fused, cb, wm, table, seg, 0,
                                 scale=3.5)
    _assert_gram_close(port, (float(v), np.asarray(g_cb), np.asarray(g_wm)),
                       atol=5e-6)


def test_gram_image_layout_loss_matches_tiles():
    """gram_cos_loss on the assembled map equals the tile-layout loss."""
    rng = np.random.default_rng(4)
    cb, wm, table, seg = _gram_case(rng, 2, 4, 3, 48, 64, nseg=32)
    img = _t(wm).reshape(3, 4, 16, 16, 2 * K).permute(4, 0, 2, 1, 3).reshape(
        2 * K, 48, 64)
    a = trainer.gram_cos_loss(_t(cb), img, _t(table), _t(seg), 1)
    b = trainer.gram_cos_loss_tiles(_t(cb), _t(wm), _t(table), _t(seg), 1)
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


# -------------------------------------------------------- model, codes, Adam

@pytest.mark.parametrize("k", [1, 4])
def test_sparse_code_gradients_match_jax(k):
    """d/dlogits of sum(weights * r) against jax.grad at 1e-6; logits that
    were not selected get exactly zero."""
    rng = np.random.default_rng(k)
    x = rng.normal(size=(300, K)).astype(np.float32)
    r = rng.normal(size=(300, k)).astype(np.float32)
    g_j = jax.grad(lambda z: jnp.sum(
        jax_codes.get_weights_and_indices(z, k)[0] * r))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    w, idx = sparse_codes.get_weights_and_indices(xt, k)
    (w * _t(r)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), atol=1e-6)
    selected = torch.zeros_like(xt, dtype=torch.bool).scatter_(1, idx, True)
    assert float(xt.grad[~selected].abs().max()) == 0.0
    if k > 1:          # at k = 1 the weight is 1 whatever the logit
        assert bool((xt.grad[selected] != 0).any())


def test_layer_feature_map_matches_jax():
    """Residual decode, value and the codebook gradient (earlier layers
    detached)."""
    rng = np.random.default_rng(5)
    f = model_fields(40, levels=3, dim=32)
    wmap = rng.normal(size=(3 * K, 6, 5)).astype(np.float32)
    cot = rng.normal(size=(32, 6, 5)).astype(np.float32)
    jm = JaxModel(**{k: jnp.asarray(v) for k, v in f.items()})

    def jloss(books):
        return jnp.sum(jm.replace(codebooks=books).compute_layer_feature_map(
            jnp.asarray(wmap), 2) * cot)

    g_j = jax.grad(jloss)(jm.codebooks)
    model = from_numpy_params(f, device="cpu")
    model.codebooks.requires_grad_(True)
    out = model.compute_layer_feature_map(_t(wmap), 2)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jm.compute_layer_feature_map(jnp.asarray(wmap), 2)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(model.codebooks.grad.numpy(), np.asarray(g_j),
                               rtol=1e-5, atol=1e-5)
    assert not model.codebooks.grad[:2].any()


def test_init_language_features():
    f = model_fields(30, levels=1)
    model = from_numpy_params(f, device="cpu")
    logits = np.arange(30 * 2 * 8, dtype=np.float32).reshape(30, 16)
    m = init_language_features(model, 2, 8, 16, logits=logits,
                               codebooks=np.ones((2, 8, 16), np.float32))
    np.testing.assert_array_equal(m.language_logits.detach().numpy(), logits)
    gen = torch.Generator().manual_seed(0)
    a = init_language_features(model, 1, 64, generator=gen)
    gen = torch.Generator().manual_seed(0)
    b = init_language_features(model, 1, 64, generator=gen)
    assert a.codebooks.shape == (1, 64, 512)
    assert torch.equal(a.language_logits, b.language_logits)
    with pytest.raises(ValueError, match="shape"):
        init_language_features(model, 1, 64, logits=logits, generator=gen)


def test_grouped_adam_matches_optax():
    """Three steps of torch Adam (beta 0.9/0.999, eps 1e-15) against the
    JAX package's adam_group on the same gradients, zeros included."""
    rng = np.random.default_rng(6)
    p0 = rng.normal(size=(50, 8)).astype(np.float32)
    grads = [rng.normal(size=(50, 8)).astype(np.float32) * 10.0 ** -s
             for s in range(3)]
    grads[1][:5] = 0.0
    tx = jax_optimizers.adam_group(0.0025)
    p_j, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p_t = torch.nn.Parameter(_t(p0))
    opt = grouped_adam({"x": (p_t, 0.0025)})
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        p_t.grad = _t(g)
        opt.step()
    np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j),
                               rtol=0, atol=1e-6)
    assert opt.param_groups[0]["name"] == "x"


def test_optimization_params_match_jax():
    import argparse

    from langsplatv2_tpu.train.config import OptimizationParams as JaxOpt
    a, b = argparse.ArgumentParser(), argparse.ArgumentParser()
    mine, ref = OptimizationParams(a), JaxOpt(b)
    assert vars(mine) == vars(ref)
    args = a.parse_args(["--language_feature_lr", "0.01"])
    assert mine.extract(args).language_feature_lr == 0.01


# ---------------------------------------------------------- camera loader

@pytest.mark.parametrize("src,dst", [((30, 40), (48, 64)), ((48, 64), (48, 64)),
                                     ((97, 61), (48, 64)), ((7, 9), (50, 33))])
def test_resize_nearest_matches_cv2(src, dst):
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(0).integers(-1, 500, src).astype(np.int32)
    ref = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(resize_nearest(img, dst[1], dst[0]), ref)


def _fov():
    fovy = math.radians(60)
    return 2 * math.atan(math.tan(fovy / 2) * W / H), fovy


@pytest.mark.parametrize("seg_hw", [(H, W), (30, 40)], ids=["same", "resized"])
def test_camera_and_compact_gt_match_jax(tmp_path, seg_hw):
    rng = np.random.default_rng(1)
    seg = rng.integers(-1, 20, (4, *seg_hw)).astype(np.int64)
    np.save(tmp_path / "v_s.npy", seg)
    np.save(tmp_path / "v_f.npy", rng.normal(size=(20, 512)))
    fovx, fovy = _fov()
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    Tv = rng.normal(size=3)
    mine = Camera(0, R, Tv, fovx, fovy, None, "v", 0, W, H)
    ref = JaxCamera(0, R, Tv, fovx, fovy, None, "v", 0, W, H)
    for name in ("world_view_transform", "full_proj_transform",
                 "camera_center"):
        np.testing.assert_allclose(getattr(mine, name), getattr(ref, name),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert (mine.tanfovx, mine.tanfovy) == (ref.tanfovx, ref.tanfovy)
    for level in (0, 2):
        t, s = mine.get_language_feature_compact(str(tmp_path), level)
        t_j, s_j = ref.get_language_feature_compact(str(tmp_path), level)
        assert t.dtype == np.float32 and s.dtype == np.int32
        np.testing.assert_array_equal(t, t_j)
        np.testing.assert_array_equal(s, s_j)
        assert s.shape == (H, W)
    with pytest.raises(ValueError, match="feature_level"):
        mine.get_language_feature_compact(str(tmp_path), 4)


# ------------------------------------------------------ the slice as a whole

N_TRAIN = 30_000
MAX_ENTRIES = 2 ** 18


def _train_scene(tmp_path):
    """30k splats at 48x64: 80% behind the origin, seen by camera B (a
    half turn about y), 20% in front of camera A. A's live total sets the
    first budget (65536); B overflows it, so its first step is redone with
    a grown budget in both packages."""
    rng = np.random.default_rng(0)
    f = model_fields(N_TRAIN, seed=2, levels=1, dim=512)
    f["xyz"][rng.uniform(size=N_TRAIN) < 0.8, 2] *= -1
    f["scaling"] = np.log(rng.uniform(0.1, 0.4, (N_TRAIN, 3))).astype(
        np.float32)
    del f["quick_weights"], f["quick_indices"]
    f["language_logits"] = rng.normal(size=(N_TRAIN, K)).astype(np.float32)
    f["live"][-100:] = False                  # padding rows never move
    for i in range(2):
        seg = rng.integers(0, 40, (4, H, W))
        seg[rng.uniform(size=seg.shape) < 0.05] = -1
        np.save(tmp_path / f"c{i}_s.npy", seg)
        np.save(tmp_path / f"c{i}_f.npy",
                rng.normal(size=(40, 512)).astype(np.float32))
    return f


def _record(module, monkeypatch, log, view_arg):
    """Wrap module.make_feature_train_step so that each step call logs
    (live_entries of its settings, the camera's view matrix, positional
    argument `view_arg` of the step)."""
    orig = module.make_feature_train_step

    def make(settings, *a, **kw):
        step = orig(settings, *a, **kw)

        def call(*args, **kwargs):
            log.append((settings.live_entries, np.asarray(args[view_arg])))
            return step(*args, **kwargs)
        return call
    monkeypatch.setattr(module, "make_feature_train_step", make)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lf")
    f = _train_scene(tmp)
    fovx, fovy = _fov()
    poses = [np.diag([-1.0, 1.0, -1.0]), np.eye(3)]     # B, A
    opt = types.SimpleNamespace(language_feature_lr=0.0025)
    kw = dict(iterations=3, seed=0, max_entries=MAX_ENTRIES)
    jax_log, port_log, port_grads = [], [], []

    with pytest.MonkeyPatch.context() as mp:
        _record(jax_trainer, mp, jax_log, 2)
        jm = JaxModel(**{k: jnp.asarray(v) for k, v in f.items()},
                      active_sh_degree=0, max_sh_degree=0)
        jcams = [JaxCamera(i, R, np.zeros(3), fovx, fovy, None, f"c{i}", i,
                           W, H) for i, R in enumerate(poses)]
        jm, _, jlogs = jax_trainer.train_features(
            jm, jcams, opt, str(tmp), 1, impl="pallas", **kw)

        _record(trainer, mp, port_log, 1)
        model = from_numpy_params(f, device="cpu")
        cams = [Camera(i, R, np.zeros(3), fovx, fovy, None, f"c{i}", i, W, H)
                for i, R in enumerate(poses)]

        def keep_grads(_it, m, _opt, _metrics):
            port_grads.append({k: getattr(m, k).grad.clone()
                               for k in trainer.FEATURE_PARAM_NAMES})

        model, _, logs = trainer.train_features(
            model, cams, opt, str(tmp), 1, device="cpu",
            on_iteration=keep_grads, **kw)
    return dict(f=f, tmp=tmp, jm=jm, jlogs=jlogs, model=model, logs=logs,
                jax_log=jax_log, port_log=port_log, port_grads=port_grads,
                jcams=jcams)


def test_train_losses_and_budgets_match_jax(trained):
    np.testing.assert_allclose(trained["logs"].losses,
                               trained["jlogs"].losses, rtol=1e-5)
    assert len(trained["logs"].losses) == 3
    # Same cameras in the same order, and the same budget sequence with
    # the grow-and-redo step: full budget, 65536, then B overflows it.
    budgets = [b for b, _ in trained["jax_log"]]
    assert budgets == [b for b, _ in trained["port_log"]]
    assert budgets[:3] == [0, 65536, 131072], budgets
    for (_, a), (_, b) in zip(trained["jax_log"], trained["port_log"]):
        np.testing.assert_array_equal(a, b)
    assert list(trained["logs"].live_budget.values()) == [131072]


def test_first_step_gradients_match_jax(trained):
    """The first step's gradients before Adam: the JAX loss of the step
    (render include_feature + fused gram loss, impl="pallas") under
    jax.grad at the initial parameters, on the first step's camera."""
    f, tmp = trained["f"], trained["tmp"]
    cam = trained["jcams"][1]                     # A is drawn first
    np.testing.assert_array_equal(trained["port_log"][0][1],
                                  cam.world_view_transform)
    table, seg = cam.get_language_feature_compact(str(tmp), 1)
    table = np.pad(table, ((0, 512 - table.shape[0]), (0, 0)))
    st = JaxSettings(H, W, cam.tanfovx, cam.tanfovy, 0,
                     max_entries=MAX_ENTRIES, impl="pallas", assemble=False)
    jm = JaxModel(**{k: jnp.asarray(v) for k, v in f.items()},
                  active_sh_degree=0, max_sh_degree=0)

    def loss(params):
        m = jm.replace(**params)
        out = jax_render(st, m, jnp.asarray(cam.world_view_transform),
                         jnp.asarray(cam.full_proj_transform),
                         jnp.asarray(cam.camera_center),
                         jnp.zeros(3, jnp.float32), include_feature=True,
                         topk=TOPK)
        return jax_gram_fused(m.codebooks, out.language_feature_weight_map,
                              jnp.asarray(table), jnp.asarray(seg), 0)

    grads = jax.grad(loss)({k: getattr(jm, k)
                            for k in trainer.FEATURE_PARAM_NAMES})
    grads["language_logits"] = jnp.where(jm.live[:, None],
                                         grads["language_logits"], 0.0)
    for k, g in trained["port_grads"][0].items():
        ref = np.asarray(grads[k])
        scale = float(np.abs(ref).max())
        assert scale > 0
        np.testing.assert_allclose(g.numpy() / scale, ref / scale, atol=1e-5,
                                   err_msg=k)


def test_final_parameters_match_jax(trained):
    """Logits and codebooks after 3 Adam steps at atol 1e-5, except where
    the port's gradient at some step is non-zero but under the noise floor
    1e-5 * max|grad|, or zero at every step: Adam's first step moves any
    parameter with a non-zero gradient by about lr, whatever its size, so
    the sign of a gradient at the level of summation noise decides a 0.005
    move. (The JAX package moves 0.1% of the logits that the port's zero
    gradient leaves in place: Gaussians reached only through blend weights
    near the 1e-4 termination threshold, with JAX gradients under 1e-5 of
    the largest, see test_first_step_gradients_match_jax.)"""
    f, jm, model = trained["f"], trained["jm"], trained["model"]
    for k in trainer.FEATURE_PARAM_NAMES:
        gs = torch.stack([g[k] for g in trained["port_grads"]])
        floor = 1e-5 * gs.abs().flatten(1).max(1).values
        tiny = ((gs != 0) & (gs.abs() < floor.reshape(-1, *[1] * (gs.dim()
                                                               - 1))))
        zero = (gs == 0).all(0).numpy()
        compared = ~(tiny.any(0).numpy() | zero)
        mine = getattr(model, k).detach().numpy()
        ref = np.asarray(getattr(jm, k))
        np.testing.assert_allclose(mine[compared], ref[compared], rtol=0,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(mine[zero], f[k][zero])
        assert compared.sum() >= 0.5 * (~zero).sum(), k
    assert not model.language_logits.grad[-100:].any()
