"""The port's XLA route (`rasterize(impl="xla")`, `ops/rasterize.py::
_rasterize_xla`) against JAX's `rasterize(impl="xla")` on the CPU, the
routing of impl="auto" (JAX's on a TPU, whose XLA route JAX's CPU "auto"
also takes for these inputs), `make_settings`' JAX positions, and
`train.cli --impl xla` against JAX's trainers with impl="xla".

Tolerances are tests/test_rasterizer_parity.py's: images atol 1e-5,
gradients 2e-5 of the largest; the telemetry (max_tile_count,
total_entries) is equal. The JAX side runs under jax.jit.
"""
import argparse
import io as pyio
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.models import gaussians as jax_gm
from langsplatv2_tpu.models import io as jax_io
from langsplatv2_tpu.models import renderer as jax_renderer
from langsplatv2_tpu.ops import RasterizeSettings as JaxSettings
from langsplatv2_tpu.ops import rasterize as jax_rasterize
from langsplatv2_tpu.scene.scene import Scene as JaxScene
from langsplatv2_tpu.train import config as jax_config
from langsplatv2_tpu.train import trainer as jax_trainer
from langsplatv2_tpu_torch.models import gaussians as gm
from langsplatv2_tpu_torch.models import io, renderer
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings, rasterize
from langsplatv2_tpu_torch.ops.temporal import build_cov3d
from langsplatv2_tpu_torch.train import cli, trainer
from scene_fixtures import make_camera, random_gaussians
from torch_port_fixtures import camera, scene, write_colmap_scene

H, W = 48, 64
BG = np.array([0.2, 0.5, 0.8], np.float32)


def _np(x):
    return None if x is None else np.array(x, np.float32)


def _settings(cls, cam, sh, **kw):
    fields = dict(image_height=H, image_width=W, tanfovx=cam["tanfovx"],
                  tanfovy=cam["tanfovy"], sh_degree=sh, max_entries=2 ** 14,
                  tile_cap=512, tile_batch=4, impl="xla")
    fields.update(kw)
    return cls(**fields)


def _port(s, cam, tensors, **kw):
    return rasterize(s, tensors["means3d"], tensors["opacities"],
                     _np(cam["viewmatrix"]), _np(cam["projmatrix"]),
                     _np(cam["campos"]), BG, device="cpu", **kw)


def _jax_fn(s, cam):
    def fn(means, ops, **kw):
        return jax_rasterize(s, means, ops, cam["viewmatrix"],
                             cam["projmatrix"], cam["campos"],
                             jnp.asarray(BG), **kw)
    return fn


def _assert_grads(port: dict, ref: dict):
    for name, b in ref.items():
        b = np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(port[name].numpy() / scale, b / scale,
                                   atol=2e-5, err_msg=name)


def test_xla_route_matches_jax_with_grads():
    """RGB at SH 3 with 8 dense channels, a background, the means2D
    carrier and a rotated camera: the images, the map, the telemetry and
    the gradients of all seven inputs."""
    rng = np.random.default_rng(0)
    n = 80
    g = random_gaussians(rng, n, feat_dim=8, sh_degree=3)
    th = np.radians(10)
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]])
    cam = make_camera(H, W, R=rot, t=np.array([0.1, -0.2, 0.3]))
    names = ("means3d", "scales", "rotations", "opacities", "shs",
             "features")
    arrays = {k: _np(g[k]) for k in names}
    arrays["means2d_dummy"] = np.zeros((n, 2), np.float32)
    wr = rng.normal(size=(3, H, W)).astype(np.float32)
    wf = rng.normal(size=(8, H, W)).astype(np.float32)
    wt = rng.normal(size=(H, W)).astype(np.float32)
    fn = _jax_fn(_settings(JaxSettings, cam, 3), cam)

    def jloss(a):
        out = fn(a["means3d"], a["opacities"], scales=a["scales"],
                 rotations=a["rotations"], shs=a["shs"],
                 features=a["features"], means2d_dummy=a["means2d_dummy"])
        return (jnp.sum(out.rgb * wr) + jnp.sum(out.feature_map * wf)
                + jnp.sum(out.final_transmittance * wt), out)

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    t = {k: torch.tensor(v, requires_grad=True) for k, v in arrays.items()}
    out = _port(_settings(RasterizeSettings, cam, 3), cam, t,
                scales=t["scales"], rotations=t["rotations"], shs=t["shs"],
                features=t["features"], means2d_dummy=t["means2d_dummy"])
    ((out.rgb * torch.from_numpy(wr)).sum()
     + (out.feature_map * torch.from_numpy(wf)).sum()
     + (out.final_transmittance * torch.from_numpy(wt)).sum()).backward()
    for a, b in ((out.rgb, ref.rgb), (out.feature_map, ref.feature_map),
                 (out.final_transmittance, ref.final_transmittance)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(ref.radii))
    assert int(out.max_tile_count) == int(ref.max_tile_count)
    assert int(out.total_entries) == int(ref.total_entries)
    assert out.live_total is None
    _assert_grads({k: v.grad for k, v in t.items()}, jgrads)


@pytest.mark.parametrize("impl,cov3d", [("auto", True)])
def test_quick_train_matches_jax(impl, cov3d):
    """quick_train at 192 channels with cov3d_precomp under impl="auto"
    (JAX's XLA route under every impl): the map, the image and
    d(quick_weights), d(means3d), d(opacities). (The route under
    impl="xla" without cov3d_precomp is held to the oracle in
    test_torch_port_reference.py, its serving form to JAX below.)"""
    rng = np.random.default_rng(1)
    n = 100
    g = random_gaussians(rng, n)
    cam = make_camera(H, W)
    qw = rng.uniform(0, 1, (n, 12)).astype(np.float32)
    qw /= qw.sum(1, keepdims=True)
    qi = np.concatenate([rng.integers(0, 64, (n, 4)) + 64 * lvl
                         for lvl in range(3)], 1).astype(np.float32)
    geo = dict(scales=_np(g["scales"]), rotations=_np(g["rotations"]))
    if cov3d:
        geo = dict(cov3d_precomp=build_cov3d(
            torch.from_numpy(geo["scales"]),
            torch.from_numpy(geo["rotations"])).numpy())
    arrays = dict(means3d=_np(g["means3d"]), opacities=_np(g["opacities"]),
                  quick_weights=qw)
    wf = rng.normal(size=(192, H, W)).astype(np.float32)
    wr = rng.normal(size=(3, H, W)).astype(np.float32)
    fn = _jax_fn(_settings(JaxSettings, cam, 0, impl=impl), cam)

    def jloss(a):
        out = fn(a["means3d"], a["opacities"], shs=g["shs"],
                 quick_weights=a["quick_weights"], quick_indices=qi,
                 quick_channels=192, quick_train=True, **geo)
        return jnp.sum(out.feature_map * wf) + jnp.sum(out.rgb * wr), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in arrays.items()})
    t = {k: torch.tensor(v, requires_grad=True) for k, v in arrays.items()}
    out = _port(_settings(RasterizeSettings, cam, 0, impl=impl), cam, t,
                shs=_np(g["shs"]), quick_weights=t["quick_weights"],
                quick_indices=qi, quick_channels=192, quick_train=True, **geo)
    ((out.feature_map * torch.from_numpy(wf)).sum()
     + (out.rgb * torch.from_numpy(wr)).sum()).backward()
    assert out.feature_map.shape == (192, H, W)
    for a, b in ((out.rgb, ref.rgb), (out.feature_map, ref.feature_map)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5)
    assert int(out.total_entries) == int(ref.total_entries)
    _assert_grads({k: v.grad for k, v in t.items()}, jgrads)


@pytest.mark.parametrize("case", ["empty", "overflow", "quick_serving"])
def test_xla_route_forward_cases(case):
    """A scene behind the camera (background, every radius 0), an entry
    budget below the live total (the unclamped total_entries, the same
    cut), and a quick serving frame under impl="xla" (JAX's one-hot
    einsum; the route ignores precision)."""
    rng = np.random.default_rng(2)
    n = 120
    g = random_gaussians(rng, n, z_range=(-5.0, -1.0) if case == "empty"
                         else (2.0, 8.0))
    cam = make_camera(H, W)
    kw = dict(scales=_np(g["scales"]), rotations=_np(g["rotations"]),
              shs=_np(g["shs"]))
    fields = dict(max_entries=256) if case == "overflow" else {}
    if case == "quick_serving":
        qw = rng.uniform(0, 1, (n, 12)).astype(np.float32)
        qi = rng.integers(0, 192, (n, 12)).astype(np.int32)
        kw.update(quick_weights=qw, quick_indices=qi, quick_channels=192)
        fields["precision"] = "bf16"
    ref = jax.jit(lambda m, o: _jax_fn(_settings(
        JaxSettings, cam, 0, **fields), cam)(m, o, **kw))(
            g["means3d"], g["opacities"])
    out = _port(_settings(RasterizeSettings, cam, 0, **fields), cam,
                dict(means3d=_np(g["means3d"]),
                     opacities=_np(g["opacities"])), **kw)
    for a, b in ((out.rgb, ref.rgb),
                 (out.final_transmittance, ref.final_transmittance)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert int(out.max_tile_count) == int(ref.max_tile_count)
    assert int(out.total_entries) == int(ref.total_entries)
    if case == "empty":
        assert (out.radii == 0).all() and int(out.total_entries) == 0
    if case == "overflow":
        assert int(out.total_entries) > 256
    if case == "quick_serving":
        np.testing.assert_allclose(out.feature_map.numpy(),
                                   np.asarray(ref.feature_map), atol=1e-5)


# ------------------------------------------------------------------ F3

# JAX's (max_tile_count, total_entries); the kernel routes' exact cull
# gives (123, 767) for both.
F3_EXPECT = {"dense": (152, 853), "rgb_cov3d": (152, 853)}


@pytest.mark.parametrize("tile_cap", [8, 256])
@pytest.mark.parametrize("case", ["dense", "rgb_cov3d"])
def test_auto_routes_like_jax(case, tile_cap):
    """F3: under impl="auto" dense features and an RGB frame with
    cov3d_precomp take the XLA route, as JAX's "auto" does on a TPU (and
    on the CPU): JAX's max_tile_count and total_entries (no exact cull),
    and at tile_cap 8, where the cap truncates tiles, JAX's pixels. The
    kernel routes' culled lists gave other counts, and other pixels at cap
    8 (up to 0.9 apart)."""
    sc = scene(300, 0)
    view, pm, tfx, tfy = camera(H, W)
    z = np.zeros(3, np.float32)
    kw = dict(colors_precomp=sc["colors"])
    if case == "dense":
        kw.update(scales=sc["scales"], rotations=sc["rotations"],
                  features=np.random.default_rng(9).uniform(
                      0, 1, (300, 64)).astype(np.float32))
    else:
        kw["cov3d_precomp"] = build_cov3d(
            torch.from_numpy(sc["scales"]),
            torch.from_numpy(sc["rotations"])).numpy()
    fields = dict(image_height=H, image_width=W, tanfovx=tfx, tanfovy=tfy,
                  sh_degree=0, max_entries=2 ** 12, tile_cap=tile_cap)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    ref = jax.jit(lambda m, o: jax_rasterize(
        JaxSettings(**fields), m, o, view, pm, z, z, **jkw))(
            sc["means"], sc["opacities"])
    out = rasterize(RasterizeSettings(**fields), sc["means"],
                    sc["opacities"], view, pm, z, z, device="cpu", **kw)
    assert (int(out.max_tile_count), int(out.total_entries)) == \
        (int(ref.max_tile_count), int(ref.total_entries)) == F3_EXPECT[case]
    pairs = [(out.rgb, ref.rgb),
             (out.final_transmittance, ref.final_transmittance)]
    if case == "dense":
        pairs.append((out.feature_map, ref.feature_map))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


# ------------------------------------------------- settings and the CLI

def test_make_settings_takes_jax_positions():
    """A positional call written for JAX (scripts/profile_rgb_train.py:66)
    gives the same settings in both packages."""
    cam = argparse.Namespace(image_height=H, image_width=W, tanfovx=0.6,
                             tanfovy=0.5)
    args = (cam, 0, 1.0, 2 ** 21, 512, 16, "xla", 4096, 1e-6, 256, 4, 0.01)
    port = renderer.make_settings(*args)._asdict()
    ref = jax_renderer.make_settings(*args)._asdict()
    assert port == {k: ref[k] for k in port}
    assert port["tile_cap"] == 512 and port["impl"] == "xla"


def _run(argv):
    out = pyio.StringIO()
    previous = sys.stdout
    sys.stdout = out
    try:
        return cli.main(argv)
    finally:
        sys.stdout = previous


def _jax_scene(src):
    random.seed(0)
    return JaxScene(src, "")


def test_cli_impl_xla_matches_jax_trainers(tmp_path, monkeypatch):
    """`train.cli --impl xla --tile_cap 64` trains both phases on a tiny
    COLMAP scene; every render's settings carry the impl and the cap; the
    losses equal JAX's train_rgb / train_features with impl="xla" on the
    same scene, seed and starting checkpoints (rtol 1e-4)."""
    src = tmp_path / "scene"
    write_colmap_scene(src, np.random.default_rng(0), n_imgs=4, n_pts=60)
    out = str(tmp_path / "out" / "m")
    seen = []

    def spy(*a, **k):
        s = renderer.make_settings(*a, **k)
        seen.append((s.impl, s.tile_cap, s.tile_batch))
        return s

    monkeypatch.setattr(trainer, "make_settings", spy)
    base = ["-s", str(src), "-m", out, "--device", "cpu", "--impl", "xla",
            "--tile_cap", "64", "--max_entries", "16384"]
    rgb = _run(base + ["--iterations", "4"])
    assert seen and set(seen) == {("xla", 64, 16)}

    # The feature phase resumes a checkpoint with language fields, which
    # both packages then train from as they are.
    model, _ = io.load_checkpoint(f"{out}_-1/chkpnt4.npz", device="cpu")
    model = gm.init_language_features(
        model, 1, 16, generator=torch.Generator().manual_seed(0))
    io.save_checkpoint(str(tmp_path / "feature.npz"), model, None, 4)
    feature = _run(base + ["--include_feature", "--start_checkpoint",
                           str(tmp_path / "feature.npz"), "--feature_level",
                           "1", "--cos_loss", "--topk", "4",
                           "--codebook_size", "16", "--iterations", "8"])
    assert feature["first_iter"] == 4 and len(feature["losses"]) == 4

    parser = argparse.ArgumentParser()
    opt = jax_config.OptimizationParams(parser).extract(parser.parse_args([]))
    jscene = _jax_scene(str(src))
    pts = np.asarray(jscene.points, np.float32)
    jm = jax_gm.create_from_pcd(pts, np.asarray(jscene.colors, np.float32),
                                spatial_lr_scale=jscene.cameras_extent,
                                max_sh_degree=3,
                                capacity=-(-pts.shape[0] // 256) * 256)
    _, _, jlogs = jax_trainer.train_rgb(
        jm, jscene.get_train_cameras(), opt, jscene.cameras_extent,
        iterations=4, tile_cap=64, max_entries=16384, impl="xla")
    np.testing.assert_allclose(rgb["losses"], jlogs.losses, rtol=1e-4)

    jm, it = jax_io.load_checkpoint_auto(str(tmp_path / "feature.npz"))
    jscene = _jax_scene(str(src))
    _, _, jlogs = jax_trainer.train_features(
        jm, jscene.get_train_cameras(), opt, str(src / "language_features"),
        1, iterations=8, first_iter=it, topk=4, tile_cap=64,
        max_entries=16384, impl="xla")
    np.testing.assert_allclose(feature["losses"], jlogs.losses, rtol=1e-4)
