"""The port's budget-capped binning and fast16 (precision="bf16") serving
against the JAX package: the windows and the transmittance budget
(ops/budget.py), the fast16 rows and K2's fast16 mode, K3 on a bf16 map,
and capped serving end to end.

JAX side as its own tests run it on the CPU: impl="pallas", Pallas kernels
in interpret mode (TestBudgetCappedBinning's and TestFastPathEndToEnd's
scenes). Port side: device="cpu", so every kernel wrapper runs its plain
version.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from langsplatv2_tpu.ops import pallas_binning, pallas_blend
from langsplatv2_tpu.ops.pallas_query import query_map_tiles as jax_query
from langsplatv2_tpu.ops.rasterize import RasterizeSettings as JaxSettings
from langsplatv2_tpu.ops.rasterize import rasterize as jax_rasterize
from langsplatv2_tpu_torch.ops import blend, budget, expand, projection, query
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings, rasterize

from torch_port_fixtures import camera, scene

H, W = 80, 112
L, K, TOPK = 3, 64, 4
BG = np.asarray([0.2, 0.1, 0.4], np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _quick_case(seed):
    """TestBudgetCappedBinning._quick_scene (seed 4) and
    TestFastPathEndToEnd's (seed 2): 800 splats at 80x112, 12 pairs of a
    merged 3-level model."""
    sc = scene(800, seed=seed)
    rng = np.random.default_rng(seed)
    qw = rng.uniform(0, 1, (800, L * TOPK)).astype(np.float32)
    qw /= qw.sum(1, keepdims=True)
    qi = np.concatenate([rng.integers(0, K, (800, TOPK)) + lvl * K
                         for lvl in range(L)], 1).astype(np.float32)
    return sc, qw, qi


def _render_both(seed, **change):
    """(JAX output, port output) of the quick render at precision="bf16"
    with the settings of the JAX tests plus `change`."""
    sc, qw, qi = _quick_case(seed)
    view, pm, tfx, tfy = camera(H, W)
    capped = change.get("tile_budget", 0.0) > 0.0
    js = JaxSettings(image_height=H, image_width=W, tanfovx=tfx,
                     tanfovy=tfy, sh_degree=0, max_entries=2 ** 13,
                     tile_cap=512, tile_batch=4, impl="pallas",
                     binning="sort", precision="bf16")._replace(**change)
    ref = jax_rasterize(
        js, jnp.asarray(sc["means"]), jnp.asarray(sc["opacities"]),
        jnp.asarray(view), jnp.asarray(pm), jnp.zeros(3, jnp.float32),
        jnp.asarray(BG), scales=jnp.asarray(sc["scales"]),
        rotations=jnp.asarray(sc["rotations"]),
        colors_precomp=jnp.asarray(sc["colors"]),
        quick_weights=jnp.asarray(qw), quick_indices=jnp.asarray(qi),
        quick_channels=L * K)
    ps = RasterizeSettings(H, W, tfx, tfy, 0, max_entries=2 ** 13,
                           precision="bf16",
                           tile_cap=512 if capped else 1024)._replace(**change)
    out = rasterize(ps, sc["means"], sc["opacities"], view, pm,
                    np.zeros(3, np.float32), BG, scales=sc["scales"],
                    rotations=sc["rotations"], colors_precomp=sc["colors"],
                    quick_weights=qw, quick_indices=qi, quick_channels=L * K,
                    device="cpu")
    return ref, out


def _max_diff(ref, out, name):
    a = np.asarray(getattr(ref, name)).astype(np.float32)
    return float(np.abs(a - getattr(out, name).float().numpy()).max())


# ------------------------------------------------- windows and the budget

@pytest.mark.parametrize("cap", [8, 128])
def test_slice_windows_matches_jax(cap):
    """Windows at every start, the tail ones included (starts at and near
    the end of the array read the padding)."""
    rng = np.random.default_rng(cap)
    arr = rng.integers(1, 1000, 300).astype(np.int32)
    starts = np.sort(rng.integers(0, 301, 40)).astype(np.int32)
    starts[-3:] = [295, 299, 300]
    ref = pallas_binning.slice_windows(jnp.asarray(arr), jnp.asarray(starts),
                                       cap)
    out = budget.slice_windows(_t(arr), _t(starts), cap)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert (out[-1] == 0).all()            # the pad id


def _windows(seed=4, cap=128):
    """The capped windows of the quick scene, from the port's binning (its
    entry sets equal JAX's, tests/test_torch_port_kernels.py)."""
    sc, _, _ = _quick_case(seed)
    view, pm, tfx, tfy = camera(H, W)
    ops = _t(sc["opacities"][:, 0])
    proj = projection.preprocess(
        _t(sc["means"]), _t(sc["scales"]), _t(sc["rotations"]), None,
        _t(sc["colors"]), _t(view), _t(pm), torch.zeros(3), tfx, tfy, W, H,
        0, 1.0, opacities=ops)
    gx, gy = -(-W // 16), -(-H // 16)
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, gx, gy, 2 ** 13)
    g, start, count = expand.sort_entries(tile, depth, gauss, gx * gy)
    g_win = budget.slice_windows(g, start, cap).reshape(-1).long()
    return proj, ops, g_win, count, gx


@pytest.mark.parametrize("rows", ["f32", "bf16"])
@pytest.mark.parametrize("subdiv", [1, 2, 4])
def test_budget_from_rows_matches_jax(subdiv, rows):
    """kept and sat_bound are integer entry sets: equal to JAX's, on the
    slots' exact f32 state (training) and on bf16-rounded conic and
    opacity (serving), at the shipped budget and at a harsh one."""
    cap = 128
    proj, ops, g_win, count, gx = _windows(cap=cap)
    conic, op = proj.conic, ops
    if rows == "bf16":
        conic, op = (x.to(torch.bfloat16).float() for x in (conic, op))
    xy, conic, op = proj.xy[g_win], conic[g_win], op[g_win]
    cut = False
    for t_budget in (1e-6, 1e-2):
        ref = pallas_binning.budget_from_rows(
            jnp.asarray(xy.numpy()), jnp.asarray(conic.numpy()),
            jnp.asarray(op.numpy()), jnp.asarray(count.numpy()), gx, cap,
            subdiv, t_budget)
        out = budget.budget_from_rows(xy, conic, op, count, gx, cap, subdiv,
                                      t_budget)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        cut |= bool((out[0] < torch.clamp(count, max=cap)).any())
    assert cut                         # the budget drops entries somewhere
    assert int(count.max()) > cap      # and some window is saturated


# ------------------------------------------------------------- fast16 rows

def test_fast16_rows_carry_jax_numerics():
    """The 64-byte row holds the values JAX's 16-wide row carries: xy f32,
    conic / opacity / rgb / weights as bf16 (round to nearest even, read
    back exactly), indices exact."""
    sc, qw, qi = _quick_case(2)
    rng = np.random.default_rng(0)
    xy = rng.uniform(-50, 150, (800, 2)).astype(np.float32)
    conic = rng.normal(size=(800, 3)).astype(np.float32)
    op = sc["opacities"][:, 0]
    ref = pallas_blend.pack_fast16_rows(
        jnp.asarray(xy), jnp.asarray(conic), jnp.asarray(op),
        jnp.asarray(sc["colors"]), jnp.asarray(qw), jnp.asarray(qi))
    hi, lo = pallas_blend._unpack_hi, pallas_blend._unpack_lo
    want_geom = np.stack(
        [ref[:, 0], ref[:, 1], hi(ref[:, 2]), lo(ref[:, 2]), hi(ref[:, 3]),
         lo(ref[:, 3]), hi(ref[:, 4]), lo(ref[:, 4]), hi(ref[:, 5])], 1)
    want_w = np.stack([f(ref[:, 10 + s]) for s in range(6)
                       for f in (hi, lo)], 1)
    rows = blend.pack_fast16_rows(_t(xy), _t(conic), _t(op),
                                  _t(sc["colors"]), _t(qw), _t(qi).int())
    assert rows.shape == (800, 16) and rows.dtype == torch.int32
    geom, w, idx = blend.unpack_fast16_rows(rows, L * TOPK)
    np.testing.assert_array_equal(geom.numpy(), np.asarray(want_geom))
    np.testing.assert_array_equal(w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(idx.numpy(), qi.astype(np.int32))


@pytest.mark.parametrize("feat_bf16", [True, False])
def test_fast16_render_matches_jax(feat_bf16):
    """The fast16 render against JAX's at JAX's own fast16 envelope (atol
    2e-2, test_quick_fast16_close_to_parity): the port blends the rounded
    state with K2's exact op sequence where the Pallas kernel uses an MXU
    polynomial and a log-domain transmittance, and with feat_bf16 a value
    near a bf16 rounding boundary may round either way (one bf16 ulp,
    4e-3 at 1.0). Entry counts are equal."""
    ref, out = _render_both(2, feat_bf16=feat_bf16)
    assert out.feature_map.dtype == (torch.bfloat16 if feat_bf16
                                     else torch.float32)
    for name in ("total_entries", "live_total", "max_tile_count"):
        assert int(getattr(out, name)) == int(getattr(ref, name)), name
    diffs = {k: _max_diff(ref, out, k)
             for k in ("rgb", "feature_map", "final_transmittance")}
    print(f"fast16 (feat_bf16={feat_bf16}) max |port - JAX|: {diffs}")
    assert max(diffs.values()) <= 2e-2, diffs
    if not feat_bf16:     # no output rounding: the blends agree closely
        assert max(diffs.values()) <= 1e-4, diffs


def _blend_inputs(seed=2):
    sc, qw, qi = _quick_case(seed)
    proj, ops, _, _, gx = _windows(seed)
    gy = -(-H // 16)
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, gx, gy, 2 ** 13)
    g, start, count = expand.sort_entries(tile, depth, gauss, gx * gy)
    rows = blend.pack_fast16_rows(proj.xy, proj.conic, ops, proj.rgb,
                                  _t(qw), _t(qi).int())
    return g, start, count, rows, gx, gy


def test_fast16_blend_is_the_f32_blend_on_the_rounded_state():
    """Outputs before bf16 rounding against blend_tiles (f32 mode) on the
    unpacked state at atol 3e-5; with feat_bf16 the same outputs rounded
    to bf16 (the final T untouched)."""
    g, start, count, rows, gx, gy = _blend_inputs()
    bg = _t(BG)
    geom, qw, qi = blend.unpack_fast16_rows(rows, L * TOPK)
    ref = blend.blend_tiles(g, start, count, geom, bg, gx, gy, qw, qi, L * K)
    raw = blend.blend_tiles_fast16(g, start, count, rows, bg, gx, gy,
                                   L * TOPK, L * K, feat_bf16=False)
    for a, b in zip(raw, ref):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0)
    rnd = blend.blend_tiles_fast16(g, start, count, rows, bg, gx, gy,
                                   L * TOPK, L * K, feat_bf16=True)
    assert rnd[1].dtype == torch.bfloat16
    torch.testing.assert_close(rnd[1], ref[1].to(torch.bfloat16), atol=0,
                               rtol=0)
    acc = ref[0] - ref[2][..., None] * bg
    ulp = 2.0 ** (torch.floor(torch.log2(acc.abs().clamp(min=1e-30))) - 7)
    assert bool(((rnd[0] - ref[0]).abs() <= ulp + 1e-6).all())
    torch.testing.assert_close(rnd[2], ref[2], atol=0, rtol=0)


def test_fast16_blend_refuses_wide_indices():
    g, start, count, rows, gx, gy = _blend_inputs()
    with pytest.raises(ValueError, match="256 channels"):
        blend.blend_tiles_fast16(g, start, count, rows, _t(BG), gx, gy,
                                 L * TOPK, 320)


# ------------------------------------------------------ K3 on a bf16 map

@pytest.mark.parametrize("levels", [1, 3])
def test_query_bf16_matches_jax(levels):
    """K3 on a bf16 map against the Pallas kernel on the same bf16 map
    (phi and gram rounded to bf16 by both, products accumulated in f32),
    rtol/atol 1e-5 against the outputs' scale; uneven tile count."""
    rng = np.random.default_rng(levels)
    t, pq = 7, 5
    wm = rng.uniform(0, 0.3, (t, 256, levels * K)).astype(np.float32)
    wm_j = jnp.asarray(wm).astype(jnp.bfloat16)
    wm_t = _t(wm).to(torch.bfloat16)
    cb = rng.normal(size=(levels, K, 32)).astype(np.float32)
    phi = np.einsum("lkd,pd->lkp", cb,
                    rng.normal(size=(pq, 32)).astype(np.float32))
    gram = np.einsum("lkd,lmd->lkm", cb, cb)
    raw_j, nrm_j = jax_query(wm_j, jnp.asarray(phi), jnp.asarray(gram),
                             interpret=True)
    raw, nrm = query.query_map_tiles(wm_t, _t(phi), _t(gram))
    for a, b in ((raw, raw_j), (nrm, nrm_j)):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=1e-5,
                                   atol=1e-5)
    # The constants really are rounded: unrounded ones give another answer.
    raw_f, _ = query.query_map_tiles_plain(wm_t.float(), _t(phi), _t(gram))
    assert float((raw_f - raw).abs().max()) > 1e-4


# ------------------------------------------------- capped serving, whole

@pytest.mark.parametrize("t_budget,cap,subdiv", [(1e-300, 256, 2),
                                                 (1e-6, 128, 2),
                                                 (1e-6, 128, 4)])
def test_capped_render_matches_jax(t_budget, cap, subdiv):
    """Capped serving: kept total (live_total), the saturation bound
    (max_tile_count) and total_entries equal JAX's; outputs within the
    fast16 envelope of JAX's (atol 2e-2)."""
    ref, out = _render_both(4, tile_budget=t_budget, tile_budget_cap=cap,
                            tile_budget_subdiv=subdiv)
    for name in ("total_entries", "live_total", "max_tile_count"):
        assert int(getattr(out, name)) == int(getattr(ref, name)), name
    diffs = {k: _max_diff(ref, out, k)
             for k in ("rgb", "feature_map", "final_transmittance")}
    assert max(diffs.values()) <= 2e-2, diffs


def test_uncrossable_budget_reproduces_the_exact_fast16_render():
    """Budget 1e-300 with a cap above the deepest tile keeps every entry:
    the capped layout reproduces the port's own exact fast16 output (atol
    1e-5, f32 tiles as in test_tiny_budget_is_output_preserving)."""
    _, full = _render_both(4, feat_bf16=False)
    assert int(full.max_tile_count) <= 256
    _, capped = _render_both(4, feat_bf16=False, tile_budget=1e-300,
                             tile_budget_cap=256)
    for name in ("rgb", "feature_map", "final_transmittance"):
        torch.testing.assert_close(getattr(capped, name),
                                   getattr(full, name), atol=1e-5, rtol=0)
    assert int(capped.live_total) == int(full.live_total)


def test_capped_relevancy_iou():
    """test_capped_relevancy_iou on the port: relevancy masks (cosine sim
    > 0.18) of the shipped budget (1e-6, cap 128) against the exact fast16
    render, both through K3 on the bf16 map, IoU >= 0.95."""
    rng = np.random.default_rng(6)
    pq = 2
    cb = rng.normal(size=(L, K, 32)).astype(np.float32)
    phrases = rng.normal(size=(pq, 32)).astype(np.float32)
    phrases /= np.linalg.norm(phrases, axis=1, keepdims=True)
    phi = _t(np.einsum("lkd,pd->lkp", cb, phrases))
    gram = _t(np.einsum("lkd,lmd->lkm", cb, cb))

    def masks(**change):
        _, out = _render_both(4, assemble=False, **change)
        assert out.feature_map.dtype == torch.bfloat16
        raw, nrm2 = query.query_map_tiles(out.feature_map, phi, gram)
        raw = raw.reshape(-1, L, pq)
        nrm = torch.sqrt(torch.clamp(nrm2.reshape(-1, L), min=0))
        return (raw / (nrm[..., None] + 1e-10) > 0.18).numpy()

    m_ref = masks()
    m_cap = masks(tile_budget=1e-6, tile_budget_cap=128)
    union = np.logical_or(m_ref, m_cap).sum()
    assert union > 0
    iou = np.logical_and(m_ref, m_cap).sum() / union
    print(f"capped relevancy IoU {iou}")
    assert iou >= 0.95, iou


def test_tile_budget_cap_must_be_lane_aligned():
    """JAX asserts it (rasterize.py:524); the port raises ValueError."""
    sc, qw, qi = _quick_case(4)
    view, pm, tfx, tfy = camera(H, W)
    s = RasterizeSettings(H, W, tfx, tfy, 0, max_entries=2 ** 13,
                          precision="bf16", tile_budget=1e-6,
                          tile_budget_cap=100)
    with pytest.raises(ValueError, match="multiple of 128"):
        rasterize(s, sc["means"], sc["opacities"], view, pm,
                  np.zeros(3, np.float32), BG, scales=sc["scales"],
                  rotations=sc["rotations"], colors_precomp=sc["colors"],
                  quick_weights=qw, quick_indices=qi, quick_channels=L * K,
                  device="cpu")


@pytest.mark.parametrize("change", [
    dict(tile_budget=1e-3), dict(precision="bf16"), dict(feat_bf16=False),
    dict(tile_budget_cap=256), dict(tile_budget_subdiv=4),
    dict(tile_cap=512)],
    ids=["tile_budget", "bf16", "feat_bf16", "cap", "subdiv", "tile_cap"])
def test_rgb_mode_ignores_the_serving_fields(change):
    """As in JAX, RGB mode reads none of the fast16 and capped fields
    (tile_cap clamps the capped routes' kept counts only): the render
    equals the default one."""
    sc = scene(300, seed=1)
    view, pm, tfx, tfy = camera(32, 48)
    base = RasterizeSettings(32, 48, tfx, tfy, 0, max_entries=2 ** 12)
    outs = [rasterize(s, sc["means"], sc["opacities"], view, pm,
                      np.zeros(3, np.float32), BG, scales=sc["scales"],
                      rotations=sc["rotations"],
                      colors_precomp=sc["colors"], device="cpu")
            for s in (base, base._replace(**change))]
    torch.testing.assert_close(outs[1].rgb, outs[0].rgb, atol=0, rtol=0)
    assert int(outs[1].live_total) == int(outs[0].live_total)
