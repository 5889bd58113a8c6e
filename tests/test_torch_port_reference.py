"""The port's per-pixel oracle (`ops/rasterize_reference.py`) and the XLA
route's binning (`ops/binning.py`) against the JAX package on the CPU, at
tests/test_rasterizer_parity.py's sizes and tolerances: images atol 1e-5,
gradients 2e-5 of the largest, finite differences rtol 2e-2 / atol 1e-4.
The oracle then holds the port's XLA route (`rasterize(impl="xla")`) in
each mode, as JAX's parity test holds JAX's. The JAX side runs under
jax.jit: eagerly its op-by-op dispatch costs seconds a call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.ops import binning as jax_binning
from langsplatv2_tpu.ops import projection as jax_projection
from langsplatv2_tpu.ops.rasterize_reference import \
    rasterize_reference as jax_reference
from langsplatv2_tpu_torch.ops import binning, projection
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings, rasterize
from langsplatv2_tpu_torch.ops.rasterize_reference import rasterize_reference
from langsplatv2_tpu_torch.utils.transforms import \
    covariance_from_scaling_rotation
from scene_fixtures import make_camera, random_gaussians

H, W = 48, 64
BG = np.array([0.2, 0.5, 0.8], np.float32)
GRAD_NAMES = ("means3d", "scales", "rotations", "opacities", "shs",
              "features", "means2d")


def _np(x):
    return None if x is None else np.array(x, np.float32)


def _rotated_camera():
    th = np.radians(10)
    rot = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                    [-np.sin(th), 0, np.cos(th)]])
    return make_camera(H, W, R=rot, t=np.array([0.1, -0.2, 0.3]))


def _cam_np(cam):
    return (_np(cam["viewmatrix"]), _np(cam["projmatrix"]),
            _np(cam["campos"]), cam["tanfovx"], cam["tanfovy"])


def _cov3d(g):
    return covariance_from_scaling_rotation(
        torch.from_numpy(_np(g["scales"])), 1.0,
        torch.from_numpy(_np(g["rotations"]))).numpy()


def _quick(rng, n, channels=192):
    qw = rng.uniform(0, 1, (n, 12)).astype(np.float32)
    qw /= qw.sum(1, keepdims=True)
    qi = np.concatenate([rng.integers(0, 64, (n, 4)) + 64 * lvl
                         for lvl in range(3)], 1).astype(np.float32)
    onehot = np.eye(channels, dtype=np.float32)[qi.astype(np.int64)]
    return qw, qi, np.einsum("ns,nsc->nc", qw, onehot)


def _jax_reference(cam, sh_degree, with_grad):
    """jit of JAX's oracle (means, opacities, scales, rotations, cov3d,
    shs, colors, features, bg, dummy) -> (rgb, feat, radii, T)."""
    def fn(m, o, s, r, cov, sh, col, f, bg, d):
        return jax_reference(m, o, s, r, cov, sh, col, f, cam["viewmatrix"],
                             cam["projmatrix"], cam["campos"],
                             cam["tanfovx"], cam["tanfovy"], W, H, sh_degree,
                             bg, means2d_dummy=d)
    if not with_grad:
        return jax.jit(fn)
    return fn


# ------------------------------------------------------------- binning

@pytest.mark.parametrize("max_entries", [2 ** 12, 300])
def test_bin_gaussians_matches_jax(max_entries):
    """K1's no-cull mode (its plain version here) and the key sort give
    JAX's searchsorted binning exactly: ids, validity, tile segments, and
    at a budget below the live total the unclamped total with the
    gaussian-major tail cut."""
    rng = np.random.default_rng(3)
    g = random_gaussians(rng, 150)
    cam = make_camera(H, W)
    gx, gy = -(-W // 16), -(-H // 16)
    view, pm, campos, tfx, tfy = _cam_np(cam)
    jproj = jax_projection.preprocess(
        g["means3d"], g["scales"], g["rotations"], None, g["shs"], None,
        cam["viewmatrix"], cam["projmatrix"], cam["campos"], tfx, tfy, W, H,
        0, 1.0)
    ref = jax.jit(lambda p: jax_binning.bin_gaussians(
        p, gx, gy, max_entries, use_pallas=False))(jproj)
    proj = projection.preprocess(
        *(torch.from_numpy(_np(g[k])) for k in ("means3d", "scales",
                                                "rotations", "shs")),
        None, *(torch.from_numpy(a) for a in (view, pm, campos)), tfx, tfy,
        W, H, 0)
    got = binning.bin_gaussians(proj, gx, gy, max_entries)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    total = int(proj.tiles_touched.sum())
    assert int(got.total_entries) == total
    assert (total > max_entries) == (max_entries == 300)


# ----------------------------------------------------------- the oracle

def test_reference_matches_jax_with_grads():
    """SH degree 3, 8 feature channels, a background and the means2D
    carrier: the images, the map, the radii and the gradients of every
    input against JAX's oracle."""
    rng = np.random.default_rng(0)
    n = 80
    g = random_gaussians(rng, n, feat_dim=8, sh_degree=3)
    cam = make_camera(H, W)
    wr = rng.normal(size=(3, H, W)).astype(np.float32)
    wf = rng.normal(size=(8, H, W)).astype(np.float32)
    wt = rng.normal(size=(H, W)).astype(np.float32)
    dummy = np.zeros((n, 2), np.float32)
    ref_fn = _jax_reference(cam, 3, True)

    def jloss(m, s, r, o, sh, f, d):
        rgb, feat, radii, t = ref_fn(m, o, s, r, None, sh, None, f,
                                     jnp.asarray(BG), d)
        return (jnp.sum(rgb * wr) + jnp.sum(feat * wf) + jnp.sum(t * wt),
                (rgb, feat, radii, t))

    args = [_np(g[k]) for k in ("means3d", "scales", "rotations",
                                "opacities", "shs", "features")] + [dummy]
    (_, ref), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=tuple(range(7)), has_aux=True))(
            *[jnp.asarray(a) for a in args])
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    view, pm, campos, tfx, tfy = _cam_np(cam)
    out = rasterize_reference(ts[0], ts[3], ts[1], ts[2], None, ts[4], None,
                              ts[5], view, pm, campos, tfx, tfy, W, H, 3, BG,
                              means2d_dummy=ts[6], device="cpu")
    loss = ((out[0] * torch.from_numpy(wr)).sum()
            + (out[1] * torch.from_numpy(wf)).sum()
            + (out[3] * torch.from_numpy(wt)).sum())
    loss.backward()
    for a, b in ((out[0], ref[0]), (out[1], ref[1]), (out[3], ref[3])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    for name, t, b in zip(GRAD_NAMES, ts, jgrads):
        b = np.asarray(b)
        scale = np.abs(b).max() + 1e-8
        np.testing.assert_allclose(t.grad.numpy() / scale, b / scale,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize("case", ["rotated", "quick192", "empty", "cov3d"])
def test_reference_forward_matches_jax(case):
    """The oracle's forward against JAX's: a rotated camera, a
    192-channel quick map (its one-hot einsum), a scene behind the camera
    (background only, every radius 0) and precomputed covariances with
    colours."""
    rng = np.random.default_rng(1)
    n = 100
    g = random_gaussians(rng, n, z_range=(-5.0, -1.0) if case == "empty"
                         else (2.0, 8.0))
    cam = _rotated_camera() if case == "rotated" else make_camera(H, W)
    feat = _quick(rng, n)[2] if case == "quick192" else None
    scales, rots, cov = _np(g["scales"]), _np(g["rotations"]), None
    shs, colors = _np(g["shs"]), None
    if case == "cov3d":
        cov, scales, rots = _cov3d(g), None, None
        shs, colors = None, rng.uniform(0, 1, (n, 3)).astype(np.float32)
    ref = _jax_reference(cam, 0, False)(
        g["means3d"], g["opacities"], scales, rots, cov, shs, colors, feat,
        jnp.asarray(BG), None)
    out = rasterize_reference(_np(g["means3d"]), _np(g["opacities"]),
                              scales, rots, cov, shs, colors, feat,
                              *_cam_np(cam), W, H, 0, BG, device="cpu")
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                               atol=1e-5)
    np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3]),
                               atol=1e-5)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    if feat is not None:
        assert out[1].shape == (192, H, W)
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                                   atol=1e-5)
    if case == "empty":
        assert (out[2] == 0).all()
        np.testing.assert_allclose(out[0].numpy(),
                                   np.broadcast_to(BG[:, None, None],
                                                   (3, H, W)), atol=1e-7)


# --------------------------------------------- the oracle holds the route

def _route_case(mode: str, seed: int = 2):
    """Inputs of one mode: (rasterize kwargs as tensors, the oracle's
    feature tensor from them, the names of the tensors whose gradients
    are compared)."""
    rng = np.random.default_rng(seed)
    n = 90
    g = random_gaussians(rng, n, sh_degree=3 if mode == "rgb_sh3" else 0,
                         feat_dim=64 if mode == "dense64" else 0)
    t = {k: torch.tensor(_np(g[k]), requires_grad=True)
         for k in ("means3d", "scales", "rotations", "opacities", "shs")}
    kw = {}
    if mode == "dense64":
        t["features"] = torch.tensor(_np(g["features"]), requires_grad=True)
        kw["features"] = t["features"]
    elif mode.startswith("quick"):
        qw, qi, _ = _quick(rng, n)
        t["quick_weights"] = torch.tensor(qw, requires_grad=True)
        kw.update(quick_weights=t["quick_weights"], quick_indices=qi,
                  quick_channels=192, quick_train=True)
    if mode == "quick_cov3d":
        t["cov3d_precomp"] = torch.tensor(_cov3d(g), requires_grad=True)
        for k in ("scales", "rotations"):
            del t[k]
    t["means2d_dummy"] = torch.zeros((n, 2), requires_grad=True)
    return t, kw


def _oracle_features(t, kw):
    if "features" in kw:
        return kw["features"]
    if "quick_weights" not in kw:
        return None
    qi = torch.as_tensor(kw["quick_indices"]).long()
    return torch.zeros((qi.shape[0], 192)).scatter_add(
        1, qi, kw["quick_weights"])


@pytest.mark.parametrize("mode", ["rgb_sh3", "dense64", "quick192",
                                  "quick_cov3d"])
def test_oracle_holds_the_xla_route(mode):
    """rasterize(impl="xla") against the oracle in each mode (RGB at SH
    3 with a background; 64 dense channels; 192 quick channels from the
    quick pairs, quick_train, with and without cov3d_precomp): the images
    atol 1e-5, the gradients of every input (the means2D carrier
    included) 2e-5 of the largest."""
    cam = make_camera(H, W)
    view, pm, campos, tfx, tfy = _cam_np(cam)
    sh = 3 if mode == "rgb_sh3" else 0
    s = RasterizeSettings(H, W, tfx, tfy, sh, max_entries=2 ** 14,
                          tile_cap=512, tile_batch=4, impl="xla")
    rng = np.random.default_rng(7)
    wr = torch.from_numpy(rng.normal(size=(3, H, W)).astype(np.float32))
    wt = torch.from_numpy(rng.normal(size=(H, W)).astype(np.float32))
    grads = []
    for route in ("xla", "oracle"):
        t, kw = _route_case(mode)
        geo = dict(scales=t.get("scales"), rotations=t.get("rotations"),
                   cov3d_precomp=t.get("cov3d_precomp"))
        if route == "xla":
            out = rasterize(s, t["means3d"], t["opacities"], view, pm,
                            campos, BG, shs=t["shs"],
                            means2d_dummy=t["means2d_dummy"], device="cpu",
                            **geo, **kw)
            rgb, feat, tt = out.rgb, out.feature_map, \
                out.final_transmittance
        else:
            rgb, feat, _, tt = rasterize_reference(
                t["means3d"], t["opacities"], geo["scales"],
                geo["rotations"], geo["cov3d_precomp"], t["shs"], None,
                _oracle_features(t, kw), view, pm, campos, tfx, tfy, W, H,
                sh, BG, means2d_dummy=t["means2d_dummy"], device="cpu")
        loss = (rgb * wr).sum() + (tt * wt).sum()
        if feat is not None:
            wf = torch.from_numpy(np.random.default_rng(8).normal(
                size=feat.shape).astype(np.float32))
            loss = loss + (feat * wf).sum()
        loss.backward()
        grads.append(({k: v.grad for k, v in t.items()},
                      [x.detach() for x in (rgb, tt)
                       + ((feat,) if feat is not None else ())]))
    (g_x, img_x), (g_r, img_r) = grads
    for a, b in zip(img_x, img_r):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    for name in g_r:
        b = g_r[name].numpy()
        scale = np.abs(b).max() + 1e-8
        assert scale > 1e-6, name
        np.testing.assert_allclose(g_x[name].numpy() / scale, b / scale,
                                   atol=2e-5, err_msg=name)


def test_xla_route_finite_differences():
    """The XLA route's opacity gradient against central differences of
    its own loss (JAX's test_grad_finite_differences)."""
    rng = np.random.default_rng(4)
    n = 30
    g = random_gaussians(rng, n)
    cam = make_camera(H, W)
    view, pm, campos, tfx, tfy = _cam_np(cam)
    s = RasterizeSettings(H, W, tfx, tfy, 0, max_entries=2 ** 12,
                          tile_cap=256, tile_batch=4, impl="xla")

    def loss(ops):
        out = rasterize(s, _np(g["means3d"]), ops, view, pm, campos,
                        np.zeros(3, np.float32), scales=_np(g["scales"]),
                        rotations=_np(g["rotations"]), shs=_np(g["shs"]),
                        device="cpu")
        return (out.rgb ** 2).sum()

    ops = torch.tensor(_np(g["opacities"]), requires_grad=True)
    loss(ops).backward()
    eps = 1e-3
    for i in (0, 7, 19):
        delta = torch.zeros((n, 1))
        delta[i, 0] = eps
        with torch.no_grad():
            fd = (float(loss(ops + delta)) - float(loss(ops - delta))) \
                / (2 * eps)
        np.testing.assert_allclose(float(ops.grad[i, 0]), fd, rtol=2e-2,
                                   atol=1e-4)


def test_no_gradient_for_invisible_gaussians():
    """Gaussians behind the camera get zero gradient on the XLA route and
    in the oracle."""
    rng = np.random.default_rng(5)
    g = random_gaussians(rng, 20, z_range=(-5.0, -1.0))
    cam = make_camera(H, W)
    view, pm, campos, tfx, tfy = _cam_np(cam)
    s = RasterizeSettings(H, W, tfx, tfy, 0, max_entries=2 ** 10,
                          tile_cap=128, tile_batch=4, impl="xla")
    z = np.zeros(3, np.float32)
    for route in ("xla", "oracle"):
        means = torch.tensor(_np(g["means3d"]), requires_grad=True)
        if route == "xla":
            rgb = rasterize(s, means, _np(g["opacities"]), view, pm, campos,
                            z, scales=_np(g["scales"]),
                            rotations=_np(g["rotations"]),
                            shs=_np(g["shs"]), device="cpu").rgb
        else:
            rgb = rasterize_reference(
                means, _np(g["opacities"]), _np(g["scales"]),
                _np(g["rotations"]), None, _np(g["shs"]), None, None, view,
                pm, campos, tfx, tfy, W, H, 0, z, device="cpu")[0]
        rgb.sum().backward()
        np.testing.assert_allclose(means.grad.numpy(), 0.0, atol=1e-7)
