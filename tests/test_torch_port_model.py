"""Parity of the port's math, model, IO and preprocess modules with the JAX
package, and the port's guards (no JAX import, no silent CPU fallback,
later-slice options raise), and the options the XLA route opened
rendering as JAX's do."""
import ast
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.eval.lerf import merge_level_models as jax_merge
from langsplatv2_tpu.models.gaussians import GaussianModel as JaxModel
from langsplatv2_tpu.ops import projection as jax_projection
from langsplatv2_tpu.utils import sh as jax_sh
from langsplatv2_tpu.utils import sparse_codes as jax_codes
from langsplatv2_tpu.utils import transforms as jax_tf
from langsplatv2_tpu_torch.eval.lerf import merge_level_models
from langsplatv2_tpu_torch.eval.openclip import OpenCLIPNetwork
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.models.renderer import render
from langsplatv2_tpu_torch.ops import projection
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings, rasterize
from langsplatv2_tpu_torch.utils import sh, sparse_codes, transforms

from torch_port_fixtures import camera, model_fields, quick_pairs, scene

REPO = Path(__file__).resolve().parents[1]


def _logits(seed=0, n=300, K=64, ties=True):
    x = np.random.default_rng(seed).normal(size=(n, K)).astype(np.float32)
    if ties:
        # Exact ties across the top-k boundary exercise the lowest-index
        # tie-break.
        x[:50, 10] = x[:50, 3]
        x[:50, 40] = x[:50, 3]
        x[50:60] = np.round(x[50:60], 1)
    return x


@pytest.mark.parametrize("k", [1, 4])
def test_weights_and_indices_match_jax(k):
    x = _logits(k)
    w_j, i_j = jax_codes.get_weights_and_indices(jnp.asarray(x), k)
    w, i = sparse_codes.get_weights_and_indices(torch.from_numpy(x), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j).astype(np.int64))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-6)


def test_topk_soft_code_matches_jax():
    x = _logits(7)
    ref = np.asarray(jax_codes.softmax_to_topk_soft_code(jnp.asarray(x), 4))
    out = sparse_codes.softmax_to_topk_soft_code(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(out.numpy() != 0, ref != 0)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_matches_jax(deg):
    rng = np.random.default_rng(deg)
    coeffs = rng.normal(size=(500, 3, max(16, (deg + 1) ** 2))).astype(
        np.float32)
    dirs = rng.normal(size=(500, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ref = jax_sh.eval_sh(deg, jnp.asarray(coeffs), jnp.asarray(dirs))
    out = sh.eval_sh(deg, torch.from_numpy(coeffs), torch.from_numpy(dirs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    rgb = rng.uniform(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(sh.rgb_to_sh(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jax_sh.rgb_to_sh(jnp.asarray(rgb))),
                               rtol=1e-6)


def test_rotation_and_covariance_match_jax():
    rng = np.random.default_rng(9)
    q = rng.normal(size=(400, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.5, (400, 3)).astype(np.float32)
    np.testing.assert_allclose(
        transforms.quat_to_rotmat(torch.from_numpy(q)).numpy(),
        np.asarray(jax_tf.quat_to_rotmat(jnp.asarray(q))), atol=1e-6)
    np.testing.assert_allclose(
        transforms.covariance_from_scaling_rotation(
            torch.from_numpy(s), 1.5, torch.from_numpy(q)).numpy(),
        np.asarray(jax_tf.covariance_from_scaling_rotation(
            jnp.asarray(s), 1.5, jnp.asarray(q))), rtol=1e-5, atol=1e-7)


def test_model_activations_and_decode_match_jax():
    f = model_fields(300, seed=6, dim=32)
    f["live"][::7] = False
    ref = _jax_model(f)
    out = from_numpy_params(f, device="cpu")
    for name in ("get_opacity", "get_scaling", "get_rotation",
                 "get_features"):
        np.testing.assert_allclose(getattr(out, name)().numpy(),
                                   np.asarray(getattr(ref, name)()),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    assert float(out.get_opacity()[::7].abs().max()) == 0.0
    wmap = np.random.default_rng(6).uniform(size=(192, 12, 10)).astype(
        np.float32)
    np.testing.assert_allclose(
        out.compute_final_feature_map(torch.from_numpy(wmap)).numpy(),
        np.asarray(ref.compute_final_feature_map(jnp.asarray(wmap))),
        rtol=1e-5, atol=1e-5)


def _level_fields(n, seed):
    f = model_fields(n, seed=seed, levels=1, dim=32)
    f["language_logits"] = _logits(seed, n=n, ties=False)
    del f["quick_weights"], f["quick_indices"]
    return f


def _jax_model(fields, sh_degree=0):
    kw = {k: jnp.asarray(v) for k, v in fields.items()}
    return JaxModel(**kw, active_sh_degree=sh_degree,
                    max_sh_degree=sh_degree)


def test_merge_level_models_matches_jax():
    levels = [_level_fields(200, s) for s in range(3)]
    ref = jax_merge([_jax_model(f) for f in levels], topk=4)
    out = merge_level_models(
        [from_numpy_params(f, device="cpu") for f in levels], topk=4)
    np.testing.assert_array_equal(
        out.quick_indices.numpy(), np.asarray(ref.quick_indices).astype(int))
    assert int(out.quick_indices.max()) < 192
    np.testing.assert_allclose(out.quick_weights.numpy(),
                               np.asarray(ref.quick_weights), atol=1e-6)
    np.testing.assert_array_equal(out.codebooks.numpy(),
                                  np.asarray(ref.codebooks))


@pytest.mark.parametrize("with_opacity", [False, True])
def test_preprocess_matches_jax(with_opacity):
    h, w = 128, 160
    sc = scene(3000, seed=4)
    view, pm, tfx, tfy = camera(h, w)
    ops = sc["opacities"][:, 0]
    shs = np.random.default_rng(4).normal(size=(3000, 16, 3)).astype(
        np.float32) * 0.3
    campos = np.asarray([0.1, -0.2, -0.5], np.float32)
    ref = jax_projection.preprocess(
        *[jnp.asarray(a) for a in (sc["means"], sc["scales"],
                                   sc["rotations"])], None,
        jnp.asarray(shs), None, jnp.asarray(view), jnp.asarray(pm),
        jnp.asarray(campos), tfx, tfy, w, h, 3, 1.0,
        opacities=jnp.asarray(ops) if with_opacity else None)
    out = projection.preprocess(
        *[torch.from_numpy(a) for a in (sc["means"], sc["scales"],
                                        sc["rotations"], shs)], None,
        torch.from_numpy(view), torch.from_numpy(pm),
        torch.from_numpy(campos), tfx, tfy, w, h, 3, 1.0,
        opacities=torch.from_numpy(ops) if with_opacity else None)
    for name in ("xy", "depth", "conic", "rgb"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("radius", "rect_min", "rect_max", "tiles_touched"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(out.tiles_touched.sum()) > 0


def test_from_numpy_params_indices():
    f = model_fields(50)
    m = from_numpy_params(f, device="cpu")
    assert m.quick_indices.dtype == torch.int32
    np.testing.assert_array_equal(m.quick_indices.numpy(),
                                  f["quick_indices"].astype(np.int32))
    assert m.max_sh_degree == 0 and m.active_sh_degree == 0
    bad = dict(f, quick_indices=f["quick_indices"] + 0.5)
    with pytest.raises(ValueError, match="non-integer"):
        from_numpy_params(bad, device="cpu")
    bad = dict(f, quick_indices=f["quick_indices"] + 64)
    with pytest.raises(ValueError, match="outside"):
        from_numpy_params(bad, device="cpu")


# -------------------------------------------------------------------- guards

def _port_files():
    return sorted((REPO / "langsplatv2_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"] + sorted(REPO.glob("profile_*.py"))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    """An AST scan (jax is pre-imported in this environment, so
    sys.modules cannot show it)."""
    banned = ("jax", "jaxlib", "flax", "langsplatv2_tpu")
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, f"{path}: {name}"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """No device argument means CUDA; without CUDA that raises instead of
    running on the CPU. The command lines (the benchmarks, PSNR, the
    render server, the whole training pipeline) raise before they read or
    write anything."""
    from langsplatv2_tpu_torch.eval import (eval_3d_ovs, eval_lerf,
                                            eval_mip_nerf360, eval_psnr)
    from langsplatv2_tpu_torch.serve import backend_renderer
    from langsplatv2_tpu_torch.train import run_all_levels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    bench = ["--dataset_name", "s", "--path_root", str(tmp_path / "none"),
             "--ckpt_root", str(tmp_path / "none"), "--output_root",
             str(out)]
    for main, argv in (
            (eval_lerf.main, bench), (eval_3d_ovs.main, bench),
            (eval_mip_nerf360.main, bench),
            (eval_psnr.main, ["-s", str(tmp_path / "none"), "-m",
                              str(tmp_path / "none")]),
            (backend_renderer.make_server,
             ["--ckpt_paths", str(tmp_path / "none")]),
            (backend_renderer.main, ["--ckpt_paths", str(tmp_path / "none")]),
            (run_all_levels.main, [str(tmp_path / "none"), str(out / "m")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert not out.exists()
    f = model_fields(20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_numpy_params(f)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OpenCLIPNetwork()
    model = from_numpy_params(f, device="cpu")
    view, pm, tfx, tfy = camera(32, 32)
    s = RasterizeSettings(32, 32, tfx, tfy, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render(s, model, view, pm, np.zeros(3, np.float32),
               np.zeros(3, np.float32), quick_render=True)


def test_scene_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The training CLI without --device, training on a Scene's cameras
    without device= and load_checkpoint_auto without device= want CUDA,
    and raise without it; the CLI before it writes anything."""
    from langsplatv2_tpu_torch.models import io
    from langsplatv2_tpu_torch.models.gaussians import create_from_pcd
    from langsplatv2_tpu_torch.scene import colmap
    from langsplatv2_tpu_torch.scene.scene import Scene
    from langsplatv2_tpu_torch.train import cli, trainer
    from PIL import Image

    sparse = tmp_path / "scene" / "sparse" / "0"
    sparse.mkdir(parents=True)
    colmap.write_intrinsics_binary(str(sparse / "cameras.bin"), {
        1: colmap.ColmapCamera(1, "PINHOLE", 32, 24,
                               np.array([30.0, 30.0, 16.0, 12.0]))})
    colmap.write_extrinsics_binary(str(sparse / "images.bin"), {
        1: colmap.ColmapImage(1, np.array([1.0, 0, 0, 0]),
                              np.array([0.0, 0, 4]), 1, "a.png")})
    colmap.write_points3d_binary(str(sparse / "points3D.bin"),
                                 np.random.default_rng(0).normal(size=(8, 3)),
                                 np.full((8, 3), 0.5))
    (tmp_path / "scene" / "images").mkdir()
    Image.fromarray(np.zeros((24, 32, 3), np.uint8)).save(
        tmp_path / "scene" / "images" / "a.png")
    model = create_from_pcd(np.random.default_rng(1).normal(size=(8, 3)),
                            np.full((8, 3), 0.5), 1.0, device="cpu")
    io.save_checkpoint(str(tmp_path / "chkpnt1.npz"), model, None, 1)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-s", str(tmp_path / "scene"), "-m",
                  str(tmp_path / "out" / "m"), "--iterations", "1"])
    assert not (tmp_path / "out").exists()
    scene = Scene(str(tmp_path / "scene"), "")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train_rgb(model, scene.get_train_cameras(),
                          types.SimpleNamespace(iterations=1), 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        io.load_checkpoint_auto(str(tmp_path / "chkpnt1.npz"))


@pytest.mark.parametrize("change", [dict(binning="gauss"),
                                    dict(pair_capacity=1024)])
def test_later_slice_options_raise(change):
    """The options of the distribution slice (Queue 1 item 12), which once
    raised as a later slice's: binning="gauss" without a mesh raises, as
    JAX asserts; pair_capacity on the sort route renders what the default
    renders, as JAX ignores it there."""
    view, pm, tfx, tfy = camera(32, 32)
    sc = scene(40, 3)
    args = (sc["means"], sc["opacities"], view, pm, np.zeros(3, np.float32),
            np.zeros(3, np.float32))
    kw = dict(scales=sc["scales"], rotations=sc["rotations"],
              colors_precomp=sc["colors"], device="cpu")
    s = RasterizeSettings(32, 32, tfx, tfy, 0, max_entries=2 ** 12)
    if "binning" in change:
        with pytest.raises(ValueError, match="mesh"):
            rasterize(s._replace(**change), *args, **kw)
        return
    ref = rasterize(s, *args, **kw)
    out = rasterize(s._replace(**change), *args, **kw)
    assert out.dropped_entries is None
    for a, b in zip(out[:6], ref[:6]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


ITEM4_CASES = {
    "rgb_cascade": (dict(binning="cascade"), {}),
    "impl_xla": (dict(impl="xla"), {}),
    "dense_colors_grad": ({}, dict(features=64, colors_precomp=True)),
    "dense_cov3d_grad": ({}, dict(features=64, cov3d_precomp=True)),
    "tile_batch_32": (dict(tile_batch=32), {}),
    "tile_batch_8": (dict(tile_batch=8), {}),
    "cascade_bf16_cells": (dict(binning="cascade", precision="bf16",
                                bf16_cells=True), {}),
    "fast16_tile_batch_8": (dict(bf16_cells=True, precision="bf16",
                                 tile_batch=8), dict(quick=True)),
}


@pytest.mark.parametrize("case", list(ITEM4_CASES))
def test_item4_options_render_like_jax(case):
    """The options the reference rasterizer's slice (Queue 1 item 4) made
    render, which raised before it: each frame against JAX's with the same
    settings (impl="auto" on the CPU: JAX's XLA route, or for the quick
    frame its fast16 kernel in interpret mode). Frames on the XLA route in
    both packages (an RGB frame on the cascade, impl="xla", dense features
    with a geometry gradient) atol 1e-5 with JAX's telemetry, and their
    gradients exist; the RGB frames at other tile_batch values (read by the
    XLA route only; the port's "auto" takes K7's route, JAX's CPU "auto"
    its XLA route) atol 3e-5; the fast16 frame within 2e-3 (bf16 cells and
    rows)."""
    import jax
    import jax.numpy as jnp

    from langsplatv2_tpu.ops import RasterizeSettings as JaxSettings
    from langsplatv2_tpu.ops import rasterize as jax_rasterize
    from langsplatv2_tpu_torch.ops.temporal import build_cov3d

    change, extra = ITEM4_CASES[case]
    n = 60
    sc = scene(n, 4)
    view, pm, tfx, tfy = camera(32, 32)
    fields = dict(image_height=32, image_width=32, tanfovx=tfx, tanfovy=tfy,
                  sh_degree=0, max_entries=2 ** 12, **change)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    arrays = dict(means3d=sc["means"], colors_precomp=sc["colors"],
                  scales=sc["scales"], rotations=sc["rotations"])
    if extra.get("cov3d_precomp"):
        arrays["cov3d_precomp"] = build_cov3d(
            torch.from_numpy(sc["scales"]),
            torch.from_numpy(sc["rotations"])).numpy()
        del arrays["scales"], arrays["rotations"]
    if extra.get("features"):
        arrays["features"] = np.random.default_rng(1).uniform(
            0, 1, (n, extra["features"])).astype(np.float32)
    quick = {}
    if extra.get("quick"):
        qw, qi = quick_pairs(n, levels=1, k=64, topk=4)
        quick = dict(quick_weights=qw, quick_indices=qi, quick_channels=64)
    grad = case.startswith("dense")
    t = {k: torch.tensor(v, requires_grad=grad) for k, v in arrays.items()}
    means = t.pop("means3d")
    out = rasterize(RasterizeSettings(**fields), means, sc["opacities"],
                    view, pm, np.zeros(3, np.float32), bg, device="cpu",
                    **t, **quick)
    jarr = {k: jnp.asarray(v) for k, v in arrays.items()}
    jmeans = jarr.pop("means3d")
    ref = jax.jit(lambda m, a: jax_rasterize(
        JaxSettings(**fields), m, jnp.asarray(sc["opacities"]), view, pm,
        jnp.zeros(3), jnp.asarray(bg), **a,
        **{k: jnp.asarray(v) if k != "quick_channels" else v
           for k, v in quick.items()}))(jmeans, jarr)
    xla = case in ("rgb_cascade", "impl_xla", "dense_colors_grad",
                   "dense_cov3d_grad", "cascade_bf16_cells")
    atol = 1e-5 if xla else (2e-3 if quick else 3e-5)
    pairs = [(out.rgb, ref.rgb)]
    if out.feature_map is not None:
        pairs.append((out.feature_map.float(), ref.feature_map))
    for a, b in pairs:
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=atol)
    if xla:
        assert int(out.max_tile_count) == int(ref.max_tile_count)
        assert int(out.total_entries) == int(ref.total_entries)
    if grad:
        (out.rgb.sum() + out.feature_map.sum()).backward()
        for k, v in [("means3d", means)] + list(t.items()):
            assert torch.isfinite(v.grad).all() and v.grad.abs().max() > 0, k


def _train_call(cameras=(), iterations=0, **kw):
    from langsplatv2_tpu_torch.train.trainer import train_features

    f = model_fields(20, levels=1)
    f["language_logits"] = np.zeros((20, 64), np.float32)
    model = from_numpy_params(f, device="cpu")
    opt = types.SimpleNamespace(language_feature_lr=0.0025)
    train_features(model, list(cameras), opt, "unused", 1,
                   iterations=iterations, device="cpu", **kw)


class _Polled(Exception):
    pass


@pytest.mark.parametrize("kwargs", [dict(gui_source_path="scene")],
                         ids=["gui"])
def test_later_training_options_raise(kwargs, monkeypatch):
    """gui_source_path is ported: the feature loop polls the viewer at the
    top of its first iteration, before any step (the poll raises here to
    show it)."""
    from langsplatv2_tpu_torch.train import trainer

    def poll(model, bg, iteration, iterations, source, max_entries,
             tile_cap, dev):
        raise _Polled(iteration, source)

    monkeypatch.setattr(trainer, "_gui_poll", poll)
    with pytest.raises(_Polled) as e:
        _train_call(iterations=1, **kwargs)
    assert e.value.args == (1, "scene")


@pytest.mark.parametrize("kwargs,match", [
    (dict(cam_batch=2, use_l1_loss=True), "gram"),
    (dict(cam_batch=2, normalize=True), "gram"),
    (dict(cam_batch=2, use_cos_loss=False, use_l1_loss=True), "gram"),
    (dict(cam_batch=2, accum_iter=2), "already accumulates"),
    (dict(cam_batch=3, iterations=1, cameras=2), "signature")],
    ids=["cam_batch-l1", "cam_batch-normalize", "cam_batch-l1-only",
         "cam_batch-accum_iter", "cam_batch-two-signatures"])
def test_training_option_conflicts_raise(kwargs, match):
    """The JAX trainer's three ValueErrors (trainer.py:890-905): camera
    batches take the Gram loss only, do not combine with accum_iter and
    need one camera signature."""
    cams = []
    for i in range(kwargs.pop("cameras", 0)):
        view, pm, tfx, tfy = camera(32, 32 + 16 * i)
        cams.append(types.SimpleNamespace(
            image_height=32, image_width=32 + 16 * i, tanfovx=tfx,
            tanfovy=tfy, image_name=f"c{i}"))
    with pytest.raises(ValueError, match=match):
        _train_call(cameras=cams, **kwargs)


def test_feature_step_redo_leaves_model_untouched():
    """A step whose forward `accept` refuses (the live-budget redo) forms no
    gradient and moves no parameter; an accepted step moves live rows and
    codebooks and leaves dead rows in place."""
    from langsplatv2_tpu_torch.train.trainer import (
        make_feature_optimizer, make_feature_train_step)

    f = model_fields(50, levels=1)
    f["language_logits"] = np.random.default_rng(0).normal(
        size=(50, 64)).astype(np.float32)
    f["live"][-5:] = False
    model = from_numpy_params(f, device="cpu")
    opt = make_feature_optimizer(
        types.SimpleNamespace(language_feature_lr=0.0025), model)
    view, pm, tfx, tfy = camera(32, 32)
    s = RasterizeSettings(32, 32, tfx, tfy, 0, max_entries=2 ** 12)
    step = make_feature_train_step(s, opt, 4)
    rng = np.random.default_rng(1)
    table = torch.from_numpy(rng.normal(size=(8, 512)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(-1, 8, (32, 32)).astype(np.int32))
    before = {k: getattr(model, k).detach().clone()
              for k in ("language_logits", "codebooks")}
    args = (model, view, pm, np.zeros(3, np.float32),
            np.zeros(3, np.float32), table, seg)
    metrics, applied = step(*args, accept=lambda m: False, device="cpu")
    assert not applied and 0.0 < float(metrics["loss"]) < 2.0
    assert int(metrics["live_total"]) > 0
    for k, v in before.items():
        assert getattr(model, k).grad is None, k
        assert torch.equal(getattr(model, k).detach(), v), k
    _, applied = step(*args, device="cpu")
    assert applied
    moved = model.language_logits.detach() != before["language_logits"]
    assert moved[:-5].any() and not moved[-5:].any()
    assert not torch.equal(model.codebooks.detach(), before["codebooks"])


def test_render_include_feature_runs_dense_features_raise():
    """Training mode renders (quick pairs from the logits); dense
    `features=` beside the training blend's quick pairs raise (the modes
    are exclusive)."""
    f = model_fields(50, levels=1)
    f["language_logits"] = np.random.default_rng(0).normal(
        size=(50, 64)).astype(np.float32)
    model = from_numpy_params(f, device="cpu")
    view, pm, tfx, tfy = camera(32, 32)
    s = RasterizeSettings(32, 32, tfx, tfy, 0, max_entries=2 ** 12)
    out = render(s, model, view, pm, np.zeros(3, np.float32),
                 np.zeros(3, np.float32), include_feature=True, topk=4,
                 device="cpu")
    assert out.language_feature_weight_map.shape == (64, 32, 32)
    z = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="exclusive"):
        rasterize(s, z, np.ones((4, 1), np.float32), view, pm,
                  np.zeros(3, np.float32), np.zeros(3, np.float32),
                  scales=z, rotations=np.ones((4, 4), np.float32),
                  features=np.zeros((4, 64), np.float32),
                  quick_weights=np.ones((4, 4), np.float32),
                  quick_indices=np.zeros((4, 4), np.int32),
                  quick_channels=64, quick_train=True, device="cpu")


@pytest.mark.parametrize("change", [dict(prefiltered=True),
                                    dict(debug=True)])
def test_unread_options_raise(change):
    view, pm, tfx, tfy = camera(32, 32)
    s = RasterizeSettings(32, 32, tfx, tfy, 0)._replace(**change)
    z = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="read by no rasterizer path"):
        rasterize(s, z, np.ones((4, 1), np.float32), view, pm,
                  np.zeros(3, np.float32), np.zeros(3, np.float32),
                  scales=z, rotations=np.ones((4, 4), np.float32),
                  device="cpu")
