"""The port's temporal binning reuse (ops/temporal.py) and the preprocess's
cov3d_precomp against the JAX package.

The scene is tests/test_temporal.py's: 800 splats at 80x112, a merged
3-level model with 12 pairs, capped at budget 1e-6 and cap 128. JAX side as
its own tests run it on the CPU (impl="pallas", Pallas kernels in interpret
mode); port side on device="cpu", so every kernel wrapper runs its plain
version.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.ops import projection as jax_projection
from langsplatv2_tpu.ops import temporal as jax_temporal
from langsplatv2_tpu.ops.rasterize import RasterizeSettings as JaxSettings
from langsplatv2_tpu.utils.camera_math import get_projection_matrix
from langsplatv2_tpu.utils.camera_math import get_world_to_view
from langsplatv2_tpu_torch.ops import blend, projection, query, temporal
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings, rasterize
from langsplatv2_tpu_torch.ops.rasterize_tiles import tiles_to_image

from torch_port_fixtures import within_one_bf16_ulp

H, W = 80, 112
L, K, TOPK = 3, 64, 4
BG = np.asarray([0.2, 0.1, 0.4], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rot_y(theta):
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _camera(R=None, t=None):
    """test_temporal.py's camera: (view, proj, campos, fovx) numpy f32."""
    fovy = math.radians(60)
    fovx = 2 * math.atan(math.tan(fovy / 2) * W / H)
    w2c = get_world_to_view(np.eye(3) if R is None else R,
                            np.zeros(3) if t is None else t)
    view = np.asarray(w2c.T, np.float32)
    pm = np.asarray(w2c.T @ get_projection_matrix(0.01, 100, fovx, fovy).T,
                    np.float32)
    campos = np.asarray(np.linalg.inv(w2c.T)[3, :3], np.float32)
    return view, pm, campos, fovx


def _yawed(px):
    fovx = _camera()[3]
    return _camera(R=_rot_y(px / (0.5 * W / math.tan(fovx / 2))))


@pytest.fixture(scope="module")
def case():
    """TestTemporalReuse._scene (seed 4) and both packages' settings."""
    rng = np.random.default_rng(4)
    n = 800
    sc = dict(
        means=np.concatenate([rng.uniform(-2, 2, (n, 2)),
                              rng.uniform(1.0, 8.0, (n, 1))], 1
                             ).astype(np.float32),
        scales=rng.uniform(0.02, 0.3, (n, 3)).astype(np.float32),
        rots=rng.normal(size=(n, 4)).astype(np.float32),
        ops=rng.uniform(0.1, 0.95, (n, 1)).astype(np.float32),
        cols=rng.uniform(0, 1, (n, 3)).astype(np.float32))
    qw = rng.uniform(0, 1, (n, L * TOPK)).astype(np.float32)
    sc["qw"] = qw / qw.sum(1, keepdims=True)
    sc["qi"] = np.concatenate([rng.integers(0, K, (n, TOPK)) + lvl * K
                               for lvl in range(L)], 1).astype(np.float32)
    fovx = _camera()[3]
    fovy = math.radians(60)
    js = JaxSettings(
        image_height=H, image_width=W, tanfovx=math.tan(fovx / 2),
        tanfovy=math.tan(fovy / 2), sh_degree=0, max_entries=2 ** 13,
        tile_cap=512, tile_batch=4, impl="pallas", binning="sort",
        precision="bf16", tile_budget=1e-6, tile_budget_cap=128)
    ps = RasterizeSettings(H, W, math.tan(fovx / 2), math.tan(fovy / 2), 0,
                           max_entries=2 ** 13, tile_cap=512,
                           precision="bf16", tile_budget=1e-6,
                           tile_budget_cap=128)
    view, pm, campos, _ = _camera()
    jcache, _ = jax_temporal.quick_bin_cache(
        js, jnp.asarray(sc["means"]), jnp.asarray(sc["ops"]),
        jnp.asarray(view), jnp.asarray(pm), jnp.asarray(campos),
        scales=jnp.asarray(sc["scales"]), rotations=jnp.asarray(sc["rots"]),
        colors_precomp=jnp.asarray(sc["cols"]),
        quick_weights=jnp.asarray(sc["qw"]),
        quick_indices=jnp.asarray(sc["qi"]))
    pcache = temporal.quick_bin_cache(
        ps, sc["means"], sc["ops"], view, pm, campos, scales=sc["scales"],
        rotations=sc["rots"], colors_precomp=sc["cols"],
        quick_weights=sc["qw"], quick_indices=sc["qi"], device="cpu")
    return dict(sc=sc, js=js, ps=ps, jcache=jcache, pcache=pcache)


def _cov3d(sc):
    return np.asarray(jax_temporal.build_cov3d(
        jnp.asarray(sc["scales"]), jnp.asarray(sc["rots"])))


# ------------------------------------------------------------ preprocess

def test_preprocess_with_cov3d_matches_jax(case):
    """project_gaussians (no opacities) and preprocess (opacity-aware
    rects) with cov3d_precomp against JAX's: xy, depth, conic and radius
    at 1e-6 relative, the rects and touched counts exact."""
    sc = case["sc"]
    view, pm, campos, _ = _yawed(3.0)
    cov = _cov3d(sc)
    s = case["ps"]
    args = (s.tanfovx, s.tanfovy, W, H)
    ref = jax_projection.project_gaussians(
        jnp.asarray(sc["means"]), None, None, jnp.asarray(cov),
        jnp.asarray(view), jnp.asarray(pm), *args)
    out = projection.project_gaussians(
        _t(sc["means"]), None, None, _t(view), _t(pm), *args,
        cov3d_precomp=_t(cov))
    for a, b in zip(out[:4], ref[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    ref = jax_projection.preprocess(
        jnp.asarray(sc["means"]), None, None, jnp.asarray(cov), None,
        jnp.asarray(sc["cols"]), jnp.asarray(view), jnp.asarray(pm),
        jnp.asarray(campos), *args, 0, 1.0,
        opacities=jnp.asarray(sc["ops"][:, 0]))
    out = projection.preprocess(
        _t(sc["means"]), None, None, None, _t(sc["cols"]), _t(view), _t(pm),
        _t(campos), *args, 0, 1.0, opacities=_t(sc["ops"][:, 0]),
        cov3d_precomp=_t(cov))
    for name in ("xy", "depth", "conic"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for name in ("radius", "rect_min", "rect_max", "tiles_touched"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_build_cov3d_and_motion_px_match_jax(case):
    """build_cov3d within 1e-6 of the largest entry (XLA may contract a
    multiply-add where torch rounds twice: off-diagonals that cancel differ
    in their last bits); motion_px, host numpy, equal."""
    sc = case["sc"]
    out = temporal.build_cov3d(_t(sc["scales"]), _t(sc["rots"]), 1.3)
    ref = np.asarray(jax_temporal.build_cov3d(jnp.asarray(sc["scales"]),
                                              jnp.asarray(sc["rots"]), 1.3))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))
    c2w = np.eye(4)
    for R, t in ((_rot_y(0.01), np.zeros(3)), (np.eye(3), [0, 0.1, 0.2]),
                 (_rot_y(-0.3), [0.5, 0.0, -1.0])):
        c2w1 = np.eye(4)
        c2w1[:3, :3], c2w1[:3, 3] = R, t
        for zref in (2.0, 0.5):
            assert temporal.motion_px(c2w, c2w1, 1000, 1.1, zref) == \
                jax_temporal.motion_px(c2w, c2w1, 1000, 1.1, zref)


# ------------------------------------------------------- the frozen binning

def test_bin_cache_counts_match_jax(case):
    """kept per tile, the kept total, the saturation bound and the
    expansion total equal JAX's; the cached state is the bin pose's."""
    jc, pc = case["jcache"], case["pcache"]
    np.testing.assert_array_equal(pc.kept.numpy(), np.asarray(jc.kept))
    for name in ("live_total", "max_tile_count", "total_entries"):
        assert int(getattr(pc, name)) == int(getattr(jc, name)), name
    assert int(pc.max_tile_count) > 128          # some window is full
    geo = np.asarray(jc.geo)[:, :10]
    np.testing.assert_allclose(pc.geo.numpy(), geo, rtol=0,
                               atol=1e-6 * float(np.abs(geo).max()))


def _steady(case, view, pm, **kw):
    return temporal.rasterize_quick_steady(
        case["ps"], case["pcache"], view, pm, BG, quick_channels=L * K,
        topk=L * TOPK, **kw)


def test_steady_frame_at_the_bin_pose_is_the_fresh_cov3d_render(case):
    """At delta 0 the steady frame equals a fresh capped render with
    cov3d_precomp: the same entries, the same blend (atol 1e-6), the same
    kept total."""
    sc = case["sc"]
    view, pm, campos, _ = _camera()
    rgb_t, feat_t, t_t = _steady(case, view, pm)
    fresh = rasterize(case["ps"]._replace(assemble=False), sc["means"],
                      sc["ops"], view, pm, campos, BG,
                      cov3d_precomp=_cov3d(sc), colors_precomp=sc["cols"],
                      quick_weights=sc["qw"], quick_indices=sc["qi"],
                      quick_channels=L * K, device="cpu")
    assert int(fresh.live_total) == int(case["pcache"].live_total)
    torch.testing.assert_close(feat_t, fresh.feature_map, atol=1e-6, rtol=0)
    s = case["ps"]
    torch.testing.assert_close(
        tiles_to_image(rgb_t, s.grid_x, s.grid_y, H, W), fresh.rgb,
        atol=1e-6, rtol=0)
    torch.testing.assert_close(
        tiles_to_image(t_t[..., None], s.grid_x, s.grid_y, H, W)[0],
        fresh.final_transmittance, atol=1e-6, rtol=0)


@pytest.mark.parametrize("px", [1.0, 12.0])
def test_steady_frame_matches_jax(case, px):
    """Steady frames 1 and 12 px from the bin pose against JAX's on the
    same frozen binning, within the fast16 envelope: the bf16 map and
    the colour (bf16 before the background is added) within one bf16 ulp,
    final T within 1e-4 (the port blends the rounded rows with K2's exact
    op sequence, the Pallas kernel with an MXU polynomial and a log-domain
    transmittance)."""
    view, pm, _, _ = _yawed(px)
    ref = jax_temporal.rasterize_quick_steady(
        case["js"], case["jcache"], jnp.asarray(view), jnp.asarray(pm),
        jnp.asarray(BG), quick_channels=L * K, topk=L * TOPK)
    rgb_j, feat_j, t_j = (_t(np.asarray(x, np.float32)) for x in ref)
    rgb, feat, t = _steady(case, view, pm)
    assert feat.dtype == torch.bfloat16
    assert within_one_bf16_ulp(feat, feat_j, 1e-6)
    bg_j = t_j[..., None] * _t(BG)
    assert within_one_bf16_ulp(rgb - bg_j, rgb_j - bg_j, 1e-4)
    assert float((t - t_j).abs().max()) <= 1e-4


def test_behind_camera_teleport_is_finite_and_skips_masked_entries(case):
    """test_behind_camera_entries_masked on the port: after a teleport past
    most of the scene the masked entries (depth <= 0.2, opacity 0) blend
    to nothing: the frame is finite and equals the blend of the windows
    without them."""
    s, pc = case["ps"], case["pcache"]
    view, pm, _, _ = _camera(t=np.array([0, 0, -6.0]))
    out = _steady(case, view, pm)
    for x in out:
        assert bool(torch.isfinite(x.float()).all())
    rows = temporal.steady_entry_geom(s, pc, view, pm)
    geom, _, _ = blend.unpack_fast16_rows(rows, L * TOPK)
    masked = geom[:, 5] == 0
    cap = s.tile_budget_cap
    slot = torch.arange(cap)[None, :]
    blended = slot < pc.kept[:, None]
    assert bool((masked.reshape(-1, cap) & blended).any())
    keep = (blended & ~masked.reshape(-1, cap))
    g = (torch.arange(keep.numel()).reshape(-1, cap))[keep].int()
    count = keep.sum(dim=1, dtype=torch.int32)
    start = (torch.cumsum(count, 0) - count).int()
    ref = blend.blend_tiles_fast16(g, start, count, rows, _t(BG), s.grid_x,
                                   s.grid_y, L * TOPK, L * K, s.feat_bf16)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("fast16", [False, True])
def test_blend_skips_non_finite_rows(case, fast16):
    """A pair whose power is NaN or +inf (xy or conic NaN or +-inf, as a
    re-projected entry near depth 0 may have) is skipped, as in the JAX
    kernel (`power <= 0` inside `valid`): the blend equals the blend of
    the same segments without those rows. K2's card test holds the kernel
    to this plain version on such rows."""
    s, pc = case["ps"], case["pcache"]
    view, pm, _, _ = _yawed(1.0)
    rows = temporal.steady_entry_geom(s, pc, view, pm)
    geom, qw, qi = blend.unpack_fast16_rows(rows, L * TOPK)
    cap = s.tile_budget_cap
    blended = torch.arange(cap)[None, :] < pc.kept[:, None]
    bad = torch.zeros(blended.shape, dtype=torch.bool)
    bad[:, 1::3] = True
    bad &= blended
    specials = [float("nan"), float("inf"), -float("inf")]
    for i, e in enumerate(torch.nonzero(bad.reshape(-1))[:, 0].tolist()):
        field = (0, 1, 2, 3, 4)[i % 5]
        geom[e, field] = specials[i % 3]
        if field < 2 and i % 3 == 1:
            geom[e, 2] = 0.0        # inf xy with a zero conic term: NaN
    keep = blended & ~bad
    g = torch.arange(keep.numel()).reshape(-1, cap)[keep].int()
    count = keep.sum(dim=1, dtype=torch.int32)
    start = (torch.cumsum(count, 0) - count).int()
    win = torch.arange(keep.numel(), dtype=torch.int32)
    starts = win[::cap].contiguous()
    bg = _t(BG)
    if fast16:
        rows_bad = blend.pack_fast16_rows(geom[:, 0:2], geom[:, 2:5],
                                          geom[:, 5], geom[:, 6:9], qw, qi)
        args = (rows_bad, bg, s.grid_x, s.grid_y, L * TOPK, L * K, False)
        out = blend.blend_tiles_fast16(win, starts, pc.kept, *args)
        ref = blend.blend_tiles_fast16(g, start, count, *args)
    else:
        args = (geom, bg, s.grid_x, s.grid_y, qw, qi, L * K)
        out = blend.blend_tiles(win, starts, pc.kept, *args)
        ref = blend.blend_tiles(g, start, count, *args)
    assert int(bad.sum()) > 100
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def _prompt_constants(pq=5, dim=32, seed=7):
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(L, K, dim)).astype(np.float32)
    phrases = rng.normal(size=(pq, dim)).astype(np.float32)
    return (np.einsum("lkd,pd->lkp", cb, phrases).astype(np.float32),
            np.einsum("lkd,lmd->lkm", cb, cb).astype(np.float32))


def test_fused_steady_frame_matches_jax(case):
    """The fused steady frame (K2q) 2 px from the bin pose against JAX's,
    both given phi and gram rounded to bf16 (what the TPU kernel's MXU pass
    reads): raw and nrm2 within 5e-3 of their largest (JAX's fused-vs-
    unfused envelope; on the CPU JAX's epilogue multiplies the f32 weights,
    the port their bf16 rounding as the TPU does), colour and final T
    within 1e-4."""
    phi, gram = (query.round_bf16(_t(x)) for x in _prompt_constants())
    view, pm, _, _ = _yawed(2.0)
    ref = jax_temporal.rasterize_quick_steady(
        case["js"], case["jcache"], jnp.asarray(view), jnp.asarray(pm),
        jnp.asarray(BG), quick_channels=L * K, topk=L * TOPK,
        phi=jnp.asarray(phi.numpy()), gram=jnp.asarray(gram.numpy()))
    out = _steady(case, view, pm, phi=phi, gram=gram)
    for i in (1, 2):
        b = np.asarray(ref[i])
        scale = float(np.abs(b).max())
        err = float(np.abs(out[i].numpy() - b).max()) / scale
        assert err <= 5e-3, (i, err)
    for i in (0, 3):
        err = float((out[i] - _t(np.asarray(ref[i]))).abs().max())
        assert err <= 1e-4, (i, err)
