"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device. This file imports neither jax nor the JAX
package, so it also runs on a machine that has only torch:

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q

(tests/conftest.py imports jax, hence --noconftest there).
"""
import numpy as np
import pytest
import torch

from langsplatv2_tpu_torch.ops import blend, budget, cascade, expand, probe, \
    query, train
from langsplatv2_tpu_torch.ops import projection

from torch_port_fixtures import (BWD_DARK_TILE, BWD_END_AT, BWD_END_TILE,
                                 CAPPED_DARK_TILE, CAPPED_END_AT,
                                 CAPPED_END_TILE, CASCADE_EDGES,
                                 CASCADE_FIELDS, GRAM_PATTERNS,
                                 bwd_edge_case, camera, capped_edge_case,
                                 cascade_budgets, cascade_edge_case,
                                 check_golden_eval, expand_edge_case,
                                 golden_eval, gram_pattern_case,
                                 quick_pairs, scene)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev):
    h, w = 256, 320
    sc = scene(4000, seed=5)
    view, pm, tfx, tfy = camera(h, w)

    def T(a):
        return torch.as_tensor(a, device=dev)

    ops = T(sc["opacities"][:, 0])
    proj = projection.preprocess(
        T(sc["means"]), T(sc["scales"]), T(sc["rotations"]), None,
        T(sc["colors"]), T(view), T(pm), torch.zeros(3, device=dev), tfx,
        tfy, w, h, 0, 1.0, opacities=ops)
    return proj, ops, -(-w // 16), -(-h // 16)


def test_expand_kernel_matches_plain(cuda):
    proj, ops, gx, gy = _case(cuda)
    tile, depth, gauss, total = expand.expand_entries(proj, ops, gx, gy,
                                                      2 ** 17)
    offsets = torch.cumsum(proj.tiles_touched, 0, dtype=torch.int64) \
        - proj.tiles_touched
    ref = expand.expand_entries_plain(proj, ops, offsets, gx, gy, 2 ** 17,
                                      True, 255.0)
    assert 0 < int(total) < 2 ** 17
    for a, b in zip((tile, depth, gauss), ref):
        assert torch.equal(a, b)


def test_blend_and_query_kernels_match_plain(cuda):
    proj, ops, gx, gy = _case(cuda)
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, gx, gy, 2 ** 17)
    g, start, count = expand.sort_entries(tile, depth, gauss, gx * gy)
    qw, qi = quick_pairs(ops.shape[0])
    qw = torch.as_tensor(qw, device=cuda)
    qi = torch.as_tensor(qi.astype(np.int32), device=cuda)
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, ops, proj.rgb)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    out = blend.blend_tiles(g, start, count, geom, bg, gx, gy, qw, qi, 192)
    ref = blend.blend_tiles_plain(g, start, count, geom, bg, gx, qw, qi, 192)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0)
    rgb = blend.blend_tiles(g, start, count, geom, bg, gx, gy)
    rgb_ref = blend.blend_tiles_plain(g, start, count, geom, bg, gx)
    torch.testing.assert_close(rgb[0], rgb_ref[0], atol=3e-5, rtol=0)
    gen = torch.Generator(device=cuda).manual_seed(0)
    phi = torch.randn(3, 64, 5, device=cuda, generator=gen)
    cb = torch.randn(3, 64, 32, device=cuda, generator=gen)
    gram = torch.einsum("lkd,lmd->lkm", cb, cb).contiguous()
    raw, nrm2 = query.query_map_tiles(out[1], phi, gram)
    raw_p, nrm2_p = query.query_map_tiles_plain(out[1], phi, gram)
    torch.testing.assert_close(raw, raw_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(nrm2, nrm2_p, rtol=1e-5, atol=1e-5)


def test_feature_bwd_kernel_matches_plain(cuda):
    """K4 against its plain version (dF rows, atol 1e-5: sums of 256 terms
    in another order), and the rows no tile blends are 0."""
    from langsplatv2_tpu_torch.ops import train

    proj, ops, gx, gy = _case(cuda)
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, gx, gy, 2 ** 17)
    g, start, count = expand.sort_entries(tile, depth, gauss, gx * gy)
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, ops, proj.rgb)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for c in (64, 192):
        cot = torch.randn(gx * gy, 256, c, device=cuda, generator=gen)
        out = train.feature_grads(g, start, count, geom, cot, gx, gy)
        ref = train.feature_grads_plain(g, start, count, geom, cot, gx)
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
        assert float(out[int(count.sum()):].abs().max()) == 0.0


@pytest.mark.parametrize("L,lay", [(1, 0), (2, 1), (3, 2)])
def test_gram_kernels_match_plain(cuda, L, lay):
    """K6a/K6b against their plain versions: per-tile sims rtol 1e-5; d_w
    scale-normalized atol 1e-5; d_phi and d_G (atomics, order varies from
    run to run) rtol 1e-4 of their largest entry."""
    from langsplatv2_tpu_torch.ops import gram

    K, gx, gy, S = 64, 5, 3, 96
    gen = torch.Generator(device=cuda).manual_seed(L * 10 + lay)
    wm = torch.randn(gx * gy, 256, L * K, device=cuda, generator=gen)
    wm[torch.rand(gx * gy, 256, device=cuda, generator=gen) < 0.1] = 0.0
    seg = torch.randint(0, S, (41, 77), device=cuda, generator=gen,
                        dtype=torch.int32)
    seg[torch.rand(41, 77, device=cuda, generator=gen) < 0.05] = -1
    table = torch.randn(S, 512, device=cuda, generator=gen)
    books = torch.randn(L, K, 512, device=cuda, generator=gen)
    seg_t = gram.seg_to_tiles(seg, gx, gy)
    rhs, gfull = gram.prep(books, table, lay)
    out = gram.gram_tiles_fwd(seg_t, wm, rhs, gfull)
    ref = gram.gram_tiles_fwd_plain(seg_t, wm, rhs, gfull, 1e-8)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)
    up = torch.tensor(2.5, device=cuda)
    got = gram.gram_tiles_bwd(seg_t, wm, rhs, gfull, lay, K, 1e-8,
                              1 / (41 * 77), up)
    want = gram.gram_tiles_bwd_plain(seg_t, wm, rhs, gfull, lay, K, 1e-8,
                                     1 / (41 * 77), up)
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a / scale, b / scale, atol=1e-4, rtol=0)


def _gram_bwd_both(case, m, dev):
    """K6b and its plain version on a gram_pattern_case."""
    from langsplatv2_tpu_torch.ops import gram

    lay = m // 64 - 1
    rhs, gfull = gram.prep(torch.as_tensor(case["codebooks"], device=dev),
                           torch.as_tensor(case["table"], device=dev), lay)
    seg = torch.as_tensor(case["seg"], device=dev)
    w = torch.as_tensor(case["w"], device=dev)
    args = (seg, w, rhs, gfull, lay, 64, 1e-8, 1.0 / seg.numel(),
            torch.tensor(1.5, device=dev))
    return gram.gram_tiles_bwd(*args), gram.gram_tiles_bwd_plain(*args)


def _assert_scaled_close(got, want, atol):
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1e-30)
        torch.testing.assert_close(a / scale, b / scale, atol=atol, rtol=0)


@pytest.mark.parametrize("pattern", GRAM_PATTERNS)
@pytest.mark.parametrize("m", [64, 128, 192])
def test_gram_bwd_kernel_segment_patterns(cuda, m, pattern):
    """K6b against its plain version (1e-4 of the largest entry: atomics
    in another order) on the segment patterns its d_phi treats apart:
    whole-warp segments with -1 holes, a tile of -1 only, 256 distinct ids
    in one tile; three tiles each."""
    got, want = _gram_bwd_both(gram_pattern_case(pattern, m, tiles=3,
                                                 seed=m), m, cuda)
    _assert_scaled_close(got, want, 1e-4)
    if pattern == "masked":
        assert not any(bool(a.any()) for a in got)


@pytest.mark.parametrize("m", [64, 192])
def test_gram_bwd_kernel_ragged_grid(cuda, m):
    """K6b on 1001 tiles (2002 half-tile chunks, not a multiple of the
    persistent grid) mixing the three segment patterns."""
    case = gram_pattern_case("warp_segments", m, tiles=1001, seed=5)
    case["seg"][1::7] = -1
    case["seg"][3::11] = np.random.default_rng(6).permutation(300)[:256]
    got, want = _gram_bwd_both(case, m, cuda)
    _assert_scaled_close(got, want, 1e-4)


@pytest.mark.parametrize("t", [1, 3, 1001])
@pytest.mark.parametrize("pq", [1, 16])
def test_query_kernels_match_plain(cuda, t, pq):
    """K3 in both modes against its plain version (rtol/atol 1e-5) at
    PQ = 1 and 16; T = 1001 gives 16,016 warp items, not a multiple of the
    persistent grid's warps."""
    gen = torch.Generator(device=cuda).manual_seed(10 * t + pq)
    wm = torch.rand(t, 256, 192, device=cuda, generator=gen)
    phi = torch.randn(3, 64, pq, device=cuda, generator=gen)
    cb = torch.randn(3, 64, 32, device=cuda, generator=gen)
    gm = torch.einsum("lkd,lmd->lkm", cb, cb).contiguous()
    for x, plain in ((wm, query.query_map_tiles_plain),
                     (wm.to(torch.bfloat16), query.query_map_tiles_bf16_plain)):
        out = query.query_map_tiles(x, phi, gm)
        ref = plain(x, phi, gm)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_rgb_bwd_kernel_matches_plain(cuda):
    """K7 against its plain version (rows within 1e-5 of the largest: sums
    of 256 pixels in another order), and RGBTrainBlend's gradients (K2, K7,
    index_add_) against the same chain of plain versions (1e-4 of the
    largest: index_add_ adds with atomics, in an order that varies)."""
    from langsplatv2_tpu_torch.ops import rgb_train

    proj, ops, gx, gy = _case(cuda)
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, gx, gy, 2 ** 17)
    g, start, count = expand.sort_entries(tile, depth, gauss, gx * gy)
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, ops, proj.rgb)
    gen = torch.Generator(device=cuda).manual_seed(2)
    rgb_t, _, t_t = blend.blend_tiles_plain(
        g, start, count, geom, torch.zeros(3, device=cuda), gx)
    g_rgb = torch.randn(gx * gy, 256, 3, device=cuda, generator=gen)
    g_t = torch.randn(gx * gy, 256, device=cuda, generator=gen)
    pack = rgb_train.make_pack(rgb_t, t_t, g_rgb, g_t)
    out = rgb_train.rgb_grads(g, start, count, geom, pack, gx, gy)
    ref = rgb_train.rgb_grads_plain(g, start, count, geom, pack, gx)
    assert out.shape == ref.shape == (int(count.sum()), 9)
    scale = float(ref.abs().max())
    assert scale > 0
    torch.testing.assert_close(out / scale, ref / scale, atol=1e-5, rtol=0)

    leaves = [t.detach().clone().requires_grad_(True)
              for t in (proj.xy, proj.conic, ops, proj.rgb)]
    rgb_k, t_k = rgb_train.RGBTrainBlend.apply(*leaves, g, start, count, gx,
                                               gy)
    ((rgb_k * g_rgb).sum() + (t_k * g_t).sum()).backward()
    torch.testing.assert_close(rgb_k, rgb_t, atol=3e-5, rtol=0)
    per = rgb_train.reduce_to_gaussians(ref, g, ops.shape[0])
    want = (per[:, 0:2], per[:, 2:5], per[:, 5], per[:, 6:9])
    for leaf, w in zip(leaves, want):
        s = max(float(w.abs().max()), 1e-30)
        torch.testing.assert_close(leaf.grad / s, w / s, atol=1e-4, rtol=0)


def test_fast16_blend_and_bf16_query_kernels_match_plain(cuda):
    """K2's fast16 mode against its plain version: f32 outputs (feat_bf16
    off) atol 3e-5; with feat_bf16 the bf16 tiles and the rounded colour
    within one bf16 ulp (the pre-rounding sums may differ in their last
    bits), final T atol 3e-5. K3 on the bf16 map against its plain version
    on the same rounded operands, rtol/atol 1e-5."""
    proj, ops, gx, gy = _case(cuda)
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, gx, gy, 2 ** 17)
    g, start, count = expand.sort_entries(tile, depth, gauss, gx * gy)
    qw, qi = quick_pairs(ops.shape[0])
    rows = blend.pack_fast16_rows(
        proj.xy, proj.conic, ops, proj.rgb, torch.as_tensor(qw, device=cuda),
        torch.as_tensor(qi.astype(np.int32), device=cuda))
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    args = (g, start, count, rows, bg, gx)
    out = blend.blend_tiles_fast16(*args, gy, 12, 192, feat_bf16=False)
    ref = blend.blend_tiles_fast16_plain(*args, 12, 192, False)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0)
    out = blend.blend_tiles_fast16(*args, gy, 12, 192, feat_bf16=True)
    ref = blend.blend_tiles_fast16_plain(*args, 12, 192, True)
    assert out[1].dtype == torch.bfloat16
    for a, b in zip(out[:2], ref[:2]):
        ulp = torch.exp2(torch.floor(torch.log2(
            b.float().abs().clamp(min=1e-30))) - 7)
        assert bool(((a.float() - b.float()).abs() <= ulp + 3e-5).all())
    torch.testing.assert_close(out[2], ref[2], atol=3e-5, rtol=0)
    gen = torch.Generator(device=cuda).manual_seed(3)
    phi = torch.randn(3, 64, 5, device=cuda, generator=gen)
    cb = torch.randn(3, 64, 32, device=cuda, generator=gen)
    gram = torch.einsum("lkd,lmd->lkm", cb, cb).contiguous()
    raw, nrm2 = query.query_map_tiles(out[1], phi, gram)
    raw_p, nrm2_p = query.query_map_tiles_bf16_plain(out[1], phi, gram)
    torch.testing.assert_close(raw, raw_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(nrm2, nrm2_p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t_budget,cap", [(1e-6, 128), (1e-300, 256)])
def test_feature_bwd_topk_kernel_matches_plain(cuda, t_budget, cap):
    """K5 against its plain version on capped windows (1e-5 of the largest
    output: sums of 256 pixels in another order); slots at or past kept[t]
    are 0."""
    from langsplatv2_tpu_torch.ops import budget, train

    proj, ops, gx, gy = _case(cuda)
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, gx, gy, 2 ** 17)
    g, start, count = expand.sort_entries(tile, depth, gauss, gx * gy)
    g_win = budget.slice_windows(g, start, cap).reshape(-1)
    gl = g_win.long()
    kept, _ = budget.budget_from_rows(proj.xy[gl], proj.conic[gl], ops[gl],
                                      count, gx, cap, 2, t_budget)
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, ops, proj.rgb)
    gen = torch.Generator(device=cuda).manual_seed(4)
    qi = torch.randint(0, 64, (ops.shape[0], 4), device=cuda, generator=gen,
                       dtype=torch.int32)
    cot = torch.randn(gx * gy, 256, 64, device=cuda, generator=gen)
    out = train.feature_grads_topk(g_win, kept, geom, qi, cot, gx, gy, cap)
    ref = train.feature_grads_topk_plain(g_win, kept, geom, qi, cot, gx, cap)
    scale = float(ref.abs().max())
    assert scale > 0
    torch.testing.assert_close(out / scale, ref / scale, atol=1e-5, rtol=0)
    dead = (torch.arange(cap, device=cuda)[None, :]
            >= kept[:, None]).reshape(-1)
    assert float(out[dead].abs().max()) == 0.0


def _fast16_case(dev):
    proj, ops, gx, gy = _case(dev)
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, gx, gy, 2 ** 17)
    g, start, count = expand.sort_entries(tile, depth, gauss, gx * gy)
    qw, qi = quick_pairs(ops.shape[0])
    qw = torch.as_tensor(qw, device=dev)
    qi = torch.as_tensor(qi.astype(np.int32), device=dev)
    return proj, ops, qw, qi, g, start, count, gx, gy


@pytest.mark.parametrize("pq", [1, 5, 16])
def test_fused_query_kernel_matches_plain(cuda, pq):
    """K2q against its plain version, with tile 0 emptied: rgb and final T
    atol 3e-5, raw and nrm2 within 1e-5 of their largest (bf16 products,
    exact in f32, summed in another order)."""
    proj, ops, qw, qi, g, start, count, gx, gy = _fast16_case(cuda)
    count = count.clone()
    count[0] = 0
    rows = blend.pack_fast16_rows(proj.xy, proj.conic, ops, proj.rgb, qw, qi)
    gen = torch.Generator(device=cuda).manual_seed(pq)
    cb = torch.randn(3, 64, 512, device=cuda, generator=gen)
    phr = torch.randn(pq, 512, device=cuda, generator=gen)
    phi = torch.einsum("lkd,pd->lkp", cb, phr).contiguous()
    gram = torch.einsum("lkd,lmd->lkm", cb, cb).contiguous()
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    args = (g, start, count, rows, bg, gx)
    before = blend.blend_tiles_query.launches
    out = blend.blend_tiles_query(*args, gy, 12, phi, gram)
    assert blend.blend_tiles_query.launches == before + 1
    ref = blend.blend_tiles_query_plain(*args, 12, phi, gram)
    assert out[1].shape == (gx * gy, 256, 3 * pq)
    for i in (0, 3):
        torch.testing.assert_close(out[i], ref[i], atol=3e-5, rtol=0)
    for i in (1, 2):
        scale = float(ref[i].abs().max())
        assert scale > 0
        torch.testing.assert_close(out[i] / scale, ref[i] / scale,
                                   atol=1e-5, rtol=0)
    assert float(out[1][0].abs().max()) == 0.0       # the empty tile
    assert bool((out[3][0] == 1.0).all())


def test_blend_kernels_skip_non_finite_rows(cuda):
    """K2 (f32 and fast16) on rows whose xy or conic is NaN or +-inf, as a
    re-projected steady-frame entry near depth 0 may have: the kernel skips
    a pair whose power is NaN, as its plain version does (atol 3e-5)."""
    proj, ops, qw, qi, g, start, count, gx, gy = _fast16_case(cuda)
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, ops, proj.rgb)
    n = geom.shape[0]
    specials = torch.tensor([float("nan"), float("inf"), -float("inf")],
                            device=cuda)
    bad = torch.arange(0, n, 7, device=cuda)
    field = bad % 5                                 # x y ca cb cc
    geom[bad, field] = specials[bad % 3]
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    out = blend.blend_tiles(g, start, count, geom, bg, gx, gy, qw, qi, 192)
    ref = blend.blend_tiles_plain(g, start, count, geom, bg, gx, qw, qi, 192)
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0)
    rows = blend.pack_fast16_rows(geom[:, 0:2], geom[:, 2:5], geom[:, 5],
                                  geom[:, 6:9], qw, qi)
    args = (g, start, count, rows, bg, gx)
    out = blend.blend_tiles_fast16(*args, gy, 12, 192, feat_bf16=False)
    ref = blend.blend_tiles_fast16_plain(*args, 12, 192, False)
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0)


def test_band_rule_on_the_card(cuda):
    """F1's smallest input (one tile, one Gaussian at (8, 8), slot 0 of
    level 0 at index 100): fast16 K2 and K2q drop the out-of-band pair by
    default, as their plain versions and JAX's banded kernel do; with
    banded=False (JAX's unbanded kernel) fast16 K2 puts 0.5 * bf16(0.7)
    there."""
    T = lambda a: torch.tensor(a, device=cuda)  # noqa: E731
    qi = T([[100] + [64 * (j // 4) + j for j in range(1, 12)]]).int()
    qw = T([[0.7] + [0.3 / 11] * 11])
    rows = blend.pack_fast16_rows(T([[8.0, 8.0]]), T([[0.05, 0.0, 0.05]]),
                                  T([0.5]), T([[0.2, 0.4, 0.6]]), qw, qi)
    one = torch.zeros(1, dtype=torch.int32, device=cuda)
    args = (one, one, one + 1, rows, torch.zeros(3, device=cuda), 1)
    centre = 8 * 16 + 8
    out = blend.blend_tiles_fast16(*args, 1, 12, 192, False)
    ref = blend.blend_tiles_fast16_plain(*args, 12, 192, False)
    assert float(out[1][0, centre, 100]) == 0.0
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0)
    off = blend.blend_tiles_fast16(*args, 1, 12, 192, False, banded=False)
    assert abs(float(off[1][0, centre, 100]) - 0.5 * 0.69921875) < 1e-6
    gen = torch.Generator(device=cuda).manual_seed(1)
    phi = torch.randn(3, 64, 2, device=cuda, generator=gen)
    gram = torch.eye(64, device=cuda).repeat(3, 1, 1)
    q = blend.blend_tiles_query(*args, 1, 12, phi, gram)
    q_ref = blend.blend_tiles_query_plain(*args, 12, phi, gram)
    for a, b in zip(q, q_ref):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["fast16", "query"])
def test_bf16_cell_kernels_match_plain(cuda, fused):
    """fast16 K2 and K2q with bf16 cells against their plain versions at
    the fast16 contract: f32 outputs atol 3e-5 (K2q: rgb and T atol 3e-5,
    raw and nrm2 1e-5 of their largest). The map (K2q: the scores) must
    differ from the f32 cells' by more than ten times that limit, so that
    a kernel that skipped the bf16 cell math fails."""
    proj, ops, qw, qi, g, start, count, gx, gy = _fast16_case(cuda)
    rows = blend.pack_fast16_rows(proj.xy, proj.conic, ops, proj.rgb, qw, qi)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    args = (g, start, count, rows, bg, gx)
    if fused:
        gen = torch.Generator(device=cuda).manual_seed(3)
        cb = torch.randn(3, 64, 64, device=cuda, generator=gen)
        phi = torch.einsum("lkd,pd->lkp", cb, torch.randn(
            5, 64, device=cuda, generator=gen)).contiguous()
        gram = torch.einsum("lkd,lmd->lkm", cb, cb).contiguous()
        out = blend.blend_tiles_query(*args, gy, 12, phi, gram,
                                      cells_bf16=True)
        ref = blend.blend_tiles_query_plain(*args, 12, phi, gram,
                                            cells_bf16=True)
        f32 = blend.blend_tiles_query(*args, gy, 12, phi, gram)
        for i in (0, 3):
            torch.testing.assert_close(out[i], ref[i], atol=3e-5, rtol=0)
        for i in (1, 2):
            scale = float(ref[i].abs().max())
            assert float((out[i] - ref[i]).abs().max()) <= 1e-5 * scale
        scale = float(f32[1].abs().max())
        assert float((out[1] - f32[1]).abs().max()) > 1e-4 * scale
    else:
        out = blend.blend_tiles_fast16(*args, gy, 12, 192, False,
                                       cells_bf16=True)
        ref = blend.blend_tiles_fast16_plain(*args, 12, 192, False,
                                             cells_bf16=True)
        f32 = blend.blend_tiles_fast16(*args, gy, 12, 192, False)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, atol=3e-5, rtol=0)
        assert float((out[1] - f32[1]).abs().max()) > 3e-4


@pytest.mark.parametrize("d", [64, 192, 256])
def test_dense_kernel_matches_plain(cuda, d):
    """K2's dense mode against its plain version (atol 3e-5; D = 256 runs
    as two channel groups), and the dense VJP's d(features) (K4 on the
    dense cotangent, index_add_) against the plain chain (1e-5 of the
    largest)."""
    proj, ops, gx, gy = _case(cuda)
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, gx, gy, 2 ** 17)
    g, start, count = expand.sort_entries(tile, depth, gauss, gx * gy)
    geom = blend.pack_gaussian_state(proj.xy, proj.conic, ops, proj.rgb)
    gen = torch.Generator(device=cuda).manual_seed(d)
    feats = torch.rand(ops.shape[0], d, device=cuda, generator=gen)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    before = blend.blend_tiles_dense.launches
    out = blend.blend_tiles_dense(g, start, count, geom, feats, bg, gx, gy)
    assert blend.blend_tiles_dense.launches == before + len(
        blend.dense_groups(d))
    ref = blend.blend_tiles_dense_plain(g, start, count, geom, feats, bg, gx)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0)
    f = feats.clone().requires_grad_(True)
    cot = torch.randn(gx * gy, 256, d, device=cuda, generator=gen)
    _, feat_t, _ = train.DenseTrainBlend.apply(f, g, start, count, geom, bg,
                                               gx, gy)
    (feat_t * cot).sum().backward()
    dfeat = train.feature_grads_plain(g, start, count, geom, cot, gx)
    want = torch.zeros_like(feats).index_add_(0, g.long(), dfeat)
    scale = float(want.abs().max())
    assert scale > 0
    torch.testing.assert_close(f.grad / scale, want / scale, atol=1e-5,
                               rtol=0)


def test_cascade_kernel_matches_plain_and_sort(cuda):
    """K8 against its plain version (every output equal) and the sort
    path's segments (equal, tile by tile); at a budget below the live total
    the overflow flag is set and the kept total fits."""
    proj, ops, gx, gy = _case(cuda)
    before = cascade.cascade_binning.launches
    out = cascade.cascade_binning(proj, ops, gx, gy, 2 ** 17)
    assert cascade.cascade_binning.launches == before + 1
    ref = cascade.cascade_binning_plain(proj, ops, gx, gy, 2 ** 17, 255.0)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    g, start, count, total, overflow = out
    assert not bool(overflow) and int(total) > 0
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, gx, gy, 2 ** 17)
    g_s, start_s, count_s = expand.sort_entries(tile, depth, gauss, gx * gy)
    assert torch.equal(count, count_s)
    n = int(total)
    pos = torch.arange(n, device=cuda)
    seg_c = torch.repeat_interleave(torch.arange(gx * gy, device=cuda),
                                    count.long())
    assert torch.equal(
        g[start.long()[seg_c] + pos - (torch.cumsum(count, 0) - count)
          .long()[seg_c]],
        g_s[start_s.long()[seg_c] + pos - (torch.cumsum(count_s, 0)
                                           - count_s).long()[seg_c]])
    small = cascade.cascade_binning(proj, ops, gx, gy, 512)
    small_ref = cascade.cascade_binning_plain(proj, ops, gx, gy, 512, 255.0)
    assert bool(small[4]) and 0 < int(small[3]) <= 512
    for a, b in zip(small, small_ref):
        assert torch.equal(a, b)


def f32_ulps(a, b):
    """|a - b| in f32 ulps of b, elementwise."""
    a, b = a.double(), b.double()
    spacing = torch.from_numpy(np.spacing(np.abs(b.cpu().numpy()).astype(
        np.float32)).astype(np.float64)).to(b.device)
    return (a - b).abs() / spacing


@pytest.mark.parametrize("subdiv", [1, 2, 4])
def test_expand_with_alpha_kernel_matches_plain(cuda, subdiv):
    """K1 with_alpha: entries equal, lm within 2 f32 ulps (the kernel and
    torch round op by op in the same order), the lm words equal."""
    proj, ops, gx, gy = _case(cuda)
    before = expand.expand_entries.alpha_launches
    tile, depth, gauss, total, lm = expand.expand_entries(
        proj, ops, gx, gy, 2 ** 17, with_alpha=subdiv)
    assert expand.expand_entries.alpha_launches == before + 1
    offsets = torch.cumsum(proj.tiles_touched, 0, dtype=torch.int64) \
        - proj.tiles_touched
    ref = expand.expand_entries_plain(proj, ops, offsets, gx, gy, 2 ** 17,
                                      True, 255.0, subdiv)
    for a, b in zip((tile, depth, gauss), ref):
        assert torch.equal(a, b)
    assert lm.shape == ref[3].shape == (subdiv * subdiv, 2 ** 17)
    assert float(f32_ulps(lm, ref[3]).max()) <= 2.0
    assert int((lm[:, int(total):] != 0).sum()) == 0
    for a, b in zip(budget.pack_lm_words(lm), budget.pack_lm_words(ref[3])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cell_chain_kernel_matches_plain(cuda, dtype):
    """K9 against its plain version on 4 blocks: f32 within 1e-5 of the
    largest, bf16 within 2 bf16 ulps of the largest."""
    x = torch.rand((4, 256, 256), generator=torch.Generator().manual_seed(0))
    x = (2 * x - 1).to(cuda)
    before = probe.cell_chain.launches
    out = probe.cell_chain(x, dtype)
    assert probe.cell_chain.launches == before + 1
    ref = probe.cell_chain_plain(x, dtype)
    big = float(ref.abs().max())
    assert 30.0 < big < 64.0 and out.dtype == torch.float32
    err = float((out - ref).abs().max())
    if dtype == torch.float32:
        assert err <= 1e-5 * big
    else:
        assert err <= 2 * 2.0 ** (np.floor(np.log2(big)) - 7)


def test_golden_eval_on_the_card(cuda):
    """tests/golden/eval_golden.npz through the port on the card (K1, K2,
    K3) at the fixture test's atol 1e-5."""
    check_golden_eval(golden_eval(cuda))


# K2's batch boundaries: tile segments of kB - 1, kB, kB + 1 and 3 kB + 5
# entries (kB: blend.BATCH, or blend.DENSE_BATCH in dense mode), an empty
# tile, and a tile whose centre pixel ends on the last entry of its first
# batch; each mode against its plain version at the existing limits, its
# stats equal to pair_counts_plain.

def _batch_case(dev, kb: int, seed: int = 0):
    """(g, start, count, geom [N, 9], qw [N, 12], unbanded qi [N, 12] in
    [0, 192), banded qi with about one index in ten out of its level's
    band, grid_x, grid_y, the ending tile, its centre pixel)."""
    rng = np.random.default_rng(seed)
    counts = [kb - 1, kb, kb + 1, 3 * kb + 5, 0, 2 * kb, 2 * kb + 3, 1]
    gx, gy, end_tile, centre = 4, 2, 5, 8 * 16 + 8
    rows = []
    for t, c in enumerate(counts):
        ox, oy = (t % gx) * 16, (t // gx) * 16
        r = np.zeros((c, 9), np.float32)
        r[:, 0] = ox + rng.uniform(-4, 20, c)
        r[:, 1] = oy + rng.uniform(-4, 20, c)
        s = rng.uniform(2.0, 9.0, (c, 2))
        r[:, 2] = 1 / s[:, 0] ** 2
        r[:, 3] = rng.uniform(-0.3, 0.3, c) / (s[:, 0] * s[:, 1])
        r[:, 4] = 1 / s[:, 1] ** 2
        r[:, 5] = rng.uniform(0.2, 0.95, c)
        r[:, 6:9] = rng.uniform(0, 1, (c, 3))
        if t == end_tile:
            # kb - 1 wide entries of alpha a at the centre, (1 - a)^(kb-1)
            # = 1e-3, then one of 0.99: T falls below 1e-4 on entry kb - 1.
            a = 1.0 - 1e-3 ** (1.0 / (kb - 1))
            r[:kb, 0:2] = [ox + 8, oy + 8]
            r[:kb, 2:5] = [1e-3, 0.0, 1e-3]
            r[:kb - 1, 5] = a
            r[kb - 1, 5] = 0.99
        rows.append(r)
    geom = np.concatenate(rows)
    n = geom.shape[0]
    g = np.arange(n, dtype=np.int32)          # each tile its own rows
    count = np.array(counts, np.int32)
    start = (np.cumsum(count) - count).astype(np.int32)
    qw = rng.uniform(0, 1, (n, 12)).astype(np.float32)
    qw /= qw.sum(1, keepdims=True)
    qi = rng.integers(0, 192, (n, 12))
    qb = np.concatenate([rng.integers(0, 64, (n, 4)) + 64 * lvl
                         for lvl in range(3)], 1)
    out = rng.uniform(0, 1, (n, 12)) < 0.1
    qb[out] = (qb[out] + 64 * rng.integers(1, 3, int(out.sum()))) % 192
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (T(g), T(start), T(count), T(geom), T(qw), T(qi.astype(np.int32)),
            T(qb.astype(np.int32)), gx, gy, end_tile, centre)


def _check_ends_on_batch_end(g, start, count, geom, gx, tile, pix, kb,
                             cells=False):
    """The constructed pixel ends on entry kb - 1 of its 2 kb: it
    evaluates exactly kb entries."""
    evaluated = torch.zeros((count.shape[0], 256), dtype=torch.int64,
                            device=geom.device)
    for _ in blend.replay_positions(g, start, count, geom, gx, cells,
                                    evaluated):
        pass
    assert int(evaluated[tile, pix]) == kb


def _assert_counts(stats, g, start, count, geom, gx, cells=False):
    want = blend.pair_counts_plain(g, start, count, geom, gx, cells)
    assert (int(stats[0]), int(stats[1])) == want


@pytest.mark.parametrize("rgb_only", [False, True], ids=["quick", "rgb"])
def test_blend_batch_boundaries_f32(cuda, rgb_only):
    """K2 f32: quick with 12 unbanded indices over all three bands (C =
    192) and at the training width (C = 64, top-4); rgb only, on segments
    cut around its own batch."""
    kb = blend.RGB_BATCH if rgb_only else blend.BATCH
    (g, start, count, geom, qw, qi, _qb, gx, gy, tile,
     pix) = _batch_case(cuda, kb)
    _check_ends_on_batch_end(g, start, count, geom, gx, tile, pix, kb)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    args = (g, start, count, geom, bg, gx)
    cases = [(None, None, 0)] if rgb_only else [
        (qw, qi, 192),
        (qw[:, :4].contiguous(), (qi[:, :4] % 64).contiguous(), 64)]
    for q_w, q_i, c in cases:
        stats = torch.zeros(2, dtype=torch.int64, device=cuda)
        out = blend.blend_tiles(*args, gy, q_w, q_i, c, stats=stats)
        ref = blend.blend_tiles_plain(*args, q_w, q_i, c)
        for a, b in zip(out, ref):
            if b is not None:
                torch.testing.assert_close(a, b, atol=3e-5, rtol=0)
        _assert_counts(stats, g, start, count, geom, gx)


@pytest.mark.parametrize("banded", [True, False], ids=["banded", "unbanded"])
@pytest.mark.parametrize("cells", [False, True], ids=["f32", "bf16_cells"])
def test_fast16_blend_batch_boundaries(cuda, cells, banded):
    """fast16 K2 (f32 outputs) with band-dropped indices, banded or not."""
    (g, start, count, geom, qw, _qi, qb, gx, gy, tile,
     pix) = _batch_case(cuda, blend.BATCH, seed=1)
    rows = blend.pack_fast16_rows(geom[:, 0:2], geom[:, 2:5], geom[:, 5],
                                  geom[:, 6:9], qw, qb)
    unpacked = blend.unpack_fast16_rows(rows, 12)[0]
    _check_ends_on_batch_end(g, start, count, unpacked, gx, tile, pix,
                             blend.BATCH, cells)
    args = (g, start, count, rows, torch.tensor([0.1, 0.2, 0.3],
                                                device=cuda), gx)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    out = blend.blend_tiles_fast16(*args, gy, 12, 192, False, stats=stats,
                                   banded=banded, cells_bf16=cells)
    ref = blend.blend_tiles_fast16_plain(*args, 12, 192, False, banded,
                                         cells)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0)
    _assert_counts(stats, g, start, count, unpacked, gx, cells)


@pytest.mark.parametrize("cells", [False, True], ids=["f32", "bf16_cells"])
@pytest.mark.parametrize("pq", [1, 16])
def test_fused_query_batch_boundaries(cuda, pq, cells):
    """K2q at PQ = 1 and 16 on the boundary segments: rgb and T atol 3e-5,
    raw and nrm2 within 1e-5 of their largest."""
    (g, start, count, geom, qw, _qi, qb, gx, gy, tile,
     pix) = _batch_case(cuda, blend.BATCH, seed=2)
    rows = blend.pack_fast16_rows(geom[:, 0:2], geom[:, 2:5], geom[:, 5],
                                  geom[:, 6:9], qw, qb)
    gen = torch.Generator(device=cuda).manual_seed(pq)
    cb = torch.randn(3, 64, 128, device=cuda, generator=gen)
    phi = torch.einsum("lkd,pd->lkp", cb, torch.randn(
        pq, 128, device=cuda, generator=gen)).contiguous()
    gram = torch.einsum("lkd,lmd->lkm", cb, cb).contiguous()
    args = (g, start, count, rows, torch.tensor([0.1, 0.2, 0.3],
                                                device=cuda), gx)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    out = blend.blend_tiles_query(*args, gy, 12, phi, gram, stats=stats,
                                  cells_bf16=cells)
    ref = blend.blend_tiles_query_plain(*args, 12, phi, gram,
                                        cells_bf16=cells)
    assert out[1].shape == (gx * gy, 256, 3 * pq)
    for i in (0, 3):
        torch.testing.assert_close(out[i], ref[i], atol=3e-5, rtol=0)
    for i in (1, 2):
        scale = float(ref[i].abs().max())
        assert scale > 0
        assert float((out[i] - ref[i]).abs().max()) <= 1e-5 * scale
    assert float(out[1][4].abs().max()) == 0.0       # the empty tile
    unpacked = blend.unpack_fast16_rows(rows, 12)[0]
    _check_ends_on_batch_end(g, start, count, unpacked, gx, tile, pix,
                             blend.BATCH, cells)
    _assert_counts(stats, g, start, count, unpacked, gx, cells)


@pytest.mark.parametrize("d", [64, 100, 192])
def test_dense_blend_batch_boundaries(cuda, d):
    """K2 dense (one channel group of D' = d) on segments cut around its
    own batch (one thread a pixel up to NARROW_DENSE columns), atol
    3e-5."""
    kb = blend.NARROW_BATCH if d <= blend.NARROW_DENSE else blend.DENSE_BATCH
    (g, start, count, geom, _qw, _qi, _qb, gx, gy, tile,
     pix) = _batch_case(cuda, kb, seed=3)
    _check_ends_on_batch_end(g, start, count, geom, gx, tile, pix, kb)
    gen = torch.Generator(device=cuda).manual_seed(d)
    feats = torch.rand(geom.shape[0], d, device=cuda, generator=gen)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    assert blend.dense_groups(d) == [(0, d)]
    out = blend.blend_tiles_dense(g, start, count, geom, feats, bg, gx, gy,
                                  stats=stats)
    ref = blend.blend_tiles_dense_plain(g, start, count, geom, feats, bg, gx)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, atol=3e-5, rtol=0)
    _assert_counts(stats, g, start, count, geom, gx)


# The training backwards' edges (K4: batches of 32 entries, chunks of 64
# channels; K7: batches of 64, groups of 4): bwd_edge_case's tiles (counts
# 1 ... 65 and 300, an empty tile with a misaligned start, a tile whose
# pixels all end on entry BWD_END_AT, a tile whose entries 8..31 no pixel
# includes, entries past the last tile's range).

def _edge_inputs(dev, seed: int = 0):
    c = bwd_edge_case(seed)
    T = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return (T(c["g"]), T(c["start"]), T(c["count"]), T(c["geom"]),
            c["grid_x"], c["grid_y"])


def _edge_zero_rows(out, start, count):
    """The rows after every pixel of the ending tile ended and the rows of
    the entries no pixel of the dark tile includes."""
    s, n = int(start[BWD_END_TILE]), int(count[BWD_END_TILE])
    d = int(start[BWD_DARK_TILE])
    return torch.cat([out[s + BWD_END_AT:s + n], out[d + 8:d + 32]])


@pytest.mark.parametrize("c", [13, 64, 192, 256])
def test_feature_bwd_kernel_edges(cuda, c):
    """K4 against its plain version (atol/rtol 1e-5) at C = 13 (one narrow
    chunk), 64, 192 and 256 (three and four chunks); rows past the last
    tile's range, after the early exit and of entries no pixel weighs are
    0."""
    g, start, count, geom, gx, gy = _edge_inputs(cuda)
    gen = torch.Generator(device=cuda).manual_seed(c)
    cot = torch.randn(gx * gy, 256, c, device=cuda, generator=gen)
    out = train.feature_grads(g, start, count, geom, cot, gx, gy)
    ref = train.feature_grads_plain(g, start, count, geom, cot, gx)
    assert float(ref.abs().max()) > 1.0
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    n = int(count.sum())
    assert out.shape == (g.shape[0], c) and g.shape[0] > n
    assert float(out[n:].abs().max()) == 0.0
    assert float(_edge_zero_rows(out, start, count).abs().max()) == 0.0


def test_rgb_bwd_kernel_edges(cuda):
    """K7 against its plain version (1e-5 of the largest) and
    RGBTrainBlend's gradients against the plain chain (1e-4 of the
    largest); rows after every pixel ended and of entries no pixel
    includes (whole groups of 8 in no warp) are 0."""
    from langsplatv2_tpu_torch.ops import rgb_train

    g, start, count, geom, gx, gy = _edge_inputs(cuda, seed=1)
    gen = torch.Generator(device=cuda).manual_seed(4)
    rgb_t, _, t_t = blend.blend_tiles_plain(
        g, start, count, geom, torch.zeros(3, device=cuda), gx)
    g_rgb = torch.randn(gx * gy, 256, 3, device=cuda, generator=gen)
    g_t = torch.randn(gx * gy, 256, device=cuda, generator=gen)
    pack = rgb_train.make_pack(rgb_t, t_t, g_rgb, g_t)
    out = rgb_train.rgb_grads(g, start, count, geom, pack, gx, gy)
    ref = rgb_train.rgb_grads_plain(g, start, count, geom, pack, gx)
    assert out.shape == ref.shape == (int(count.sum()), 9)
    scale = float(ref.abs().max())
    assert scale > 1.0
    torch.testing.assert_close(out / scale, ref / scale, atol=1e-5, rtol=0)
    assert float(_edge_zero_rows(out, start, count).abs().max()) == 0.0

    xy, conic, op, rgb = geom[:, 0:2], geom[:, 2:5], geom[:, 5], geom[:, 6:9]
    leaves = [t.clone().requires_grad_(True) for t in (xy, conic, op, rgb)]
    rgb_k, t_k = rgb_train.RGBTrainBlend.apply(*leaves, g, start, count, gx,
                                               gy)
    ((rgb_k * g_rgb).sum() + (t_k * g_t).sum()).backward()
    per = rgb_train.reduce_to_gaussians(ref, g, geom.shape[0])
    want = (per[:, 0:2], per[:, 2:5], per[:, 5], per[:, 6:9])
    for leaf, w in zip(leaves, want):
        s = max(float(w.abs().max()), 1e-30)
        torch.testing.assert_close(leaf.grad / s, w / s, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# Shapes past the main path's designs: K3, K2q, K6a and K6b take every shape
# the JAX kernels take (tests/test_torch_port_f2.py holds the plain versions
# to JAX's at these shapes), each within its existing limit of its plain
# version.

def _query_consts(levels, k, pq, dev, seed):
    """phi [L, K, PQ] standard normal and gram [L, K, K] of 32-d codebooks,
    as test_query_kernels_match_plain draws them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    phi = torch.randn(levels, k, pq, device=dev, generator=gen)
    cb = torch.randn(levels, k, 32, device=dev, generator=gen)
    return phi, torch.einsum("lkd,lmd->lkm", cb, cb).contiguous()


@pytest.mark.parametrize("k", [20, 32])
@pytest.mark.parametrize("pq", [17, 33])
def test_query_kernels_any_shape(cuda, pq, k):
    """K3 in both modes at L = 4, K = 20 and 32, PQ = 17 and 33 (the
    general design) against its plain version (rtol/atol 1e-5), on 3 tiles
    and on 1001 (16,016 warp items, not a multiple of the persistent
    grid's warps)."""
    phi, gm = _query_consts(4, k, pq, cuda, pq + k)
    gen = torch.Generator(device=cuda).manual_seed(k)
    for t in (3, 1001):
        wm = torch.rand(t, 256, 4 * k, device=cuda, generator=gen)
        for x, plain in ((wm, query.query_map_tiles_plain),
                         (wm.to(torch.bfloat16),
                          query.query_map_tiles_bf16_plain)):
            out = query.query_map_tiles(x, phi, gm)
            ref = plain(x, phi, gm)
            assert out[0].shape == (t, 256, 4 * pq)
            for a, b in zip(out, ref):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _fused_any_case(dev, levels, k, pq, seed):
    proj, ops, gx, gy = _case(dev)
    tile, depth, gauss, _ = expand.expand_entries(proj, ops, gx, gy, 2 ** 17)
    g, start, count = expand.sort_entries(tile, depth, gauss, gx * gy)
    count = count.clone()
    count[0] = 0
    topk = 12 // levels
    qw, qi = quick_pairs(ops.shape[0], levels=levels, k=k, topk=topk)
    rows = blend.pack_fast16_rows(
        proj.xy, proj.conic, ops, proj.rgb, torch.as_tensor(qw, device=dev),
        torch.as_tensor(qi.astype(np.int32), device=dev))
    phi, gram = _query_consts(levels, k, pq, dev, seed)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    return (g, start, count, rows, bg, gx), gy, levels * topk, phi, gram


@pytest.mark.parametrize("cells", [False, True], ids=["f32", "bf16_cells"])
@pytest.mark.parametrize("levels,k,pq", [(4, 32, 17), (3, 64, 17),
                                         (8, 32, 17), (1, 256, 5)])
def test_fused_query_kernel_any_shape(cuda, levels, k, pq, cells):
    """K2q past its main-path design against its plain version: rgb and T
    atol 3e-5, raw and nrm2 within 1e-5 of their largest, the pair counts
    equal. PQ = 17 at K = 32 and 64 (one block a tile); L*K = 256 (a
    cluster of two blocks a tile, each holding 128 channels): 8 levels of
    32, and one level of 256 that straddles the two halves."""
    args, gy, slots, phi, gram = _fused_any_case(cuda, levels, k, pq, 7)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    out = blend.blend_tiles_query(*args, gy, slots, phi, gram, stats=stats,
                                  cells_bf16=cells)
    ref = blend.blend_tiles_query_plain(*args, slots, phi, gram,
                                        cells_bf16=cells)
    assert out[1].shape == (args[2].shape[0], 256, levels * pq)
    for i in (0, 3):
        torch.testing.assert_close(out[i], ref[i], atol=3e-5, rtol=0)
    for i in (1, 2):
        scale = float(ref[i].abs().max())
        assert scale > 0
        assert float((out[i] - ref[i]).abs().max()) <= 1e-5 * scale
    assert float(out[1][0].abs().max()) == 0.0       # the empty tile
    assert bool((out[3][0] == 1.0).all())
    unpacked = blend.unpack_fast16_rows(args[3], slots)[0]
    _assert_counts(stats, *args[:3], unpacked, args[5], cells)


def _gram_case(pattern, m, k, tiles, seed, dev, extra: int = 0):
    """gram_pattern_case's inputs on the card, the map `extra` columns
    wider than M (the layers above lay)."""
    from langsplatv2_tpu_torch.ops import gram

    case = gram_pattern_case(pattern, m, tiles=tiles, seed=seed, k=k)
    rng = np.random.default_rng(seed + 1)
    w = np.concatenate([case["w"], rng.standard_normal(
        (tiles, 256, extra)).astype(np.float32)], axis=2)
    lay = m // k - 1
    rhs, gfull = gram.prep(torch.as_tensor(case["codebooks"], device=dev),
                           torch.as_tensor(case["table"], device=dev), lay)
    return (torch.as_tensor(case["seg"], device=dev),
            torch.as_tensor(w, device=dev), rhs, gfull), lay


# (M, K, map columns past M): M = 8 .. 320, K = 7 .. 96: one k-panel with
# G resident, the ring, layer blocks past the first panel, map rows that are
# not whole 16-byte vectors (4-byte copies), K = 64 at M = 64, 192 and 256
# on the compile-time-width code (a map width that is a multiple of 4) and
# on the run-time-width one, two layer blocks (K = 96) and the unstaged
# route (M = 320).
GRAM_WIDTHS = [(8, 8, 0), (21, 7, 5), (24, 8, 3), (32, 32, 0), (64, 32, 4),
               (96, 32, 5), (64, 64, 0), (64, 64, 5), (192, 64, 0),
               (192, 64, 5), (256, 64, 0), (256, 64, 3), (192, 96, 0),
               (320, 64, 0)]


@pytest.mark.parametrize("pattern", GRAM_PATTERNS)
@pytest.mark.parametrize("m,k,extra", GRAM_WIDTHS)
def test_gram_kernels_any_width(cuda, m, k, extra, pattern):
    """K6a (per-tile sums rtol 1e-5, atol 1e-3) and K6b (1e-4 of the
    largest entry: atomics in another order) against their plain versions
    at every width of GRAM_WIDTHS on the segment patterns, 3 tiles each; a
    tile of -1 only gives zero sums and gradients."""
    from langsplatv2_tpu_torch.ops import gram

    (seg, w, rhs, gfull), lay = _gram_case(pattern, m, k, 3, m + k, cuda,
                                           extra)
    out = gram.gram_tiles_fwd(seg, w, rhs, gfull)
    ref = gram.gram_tiles_fwd_plain(seg, w, rhs, gfull, 1e-8)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3)
    args = (seg, w, rhs, gfull, lay, k, 1e-8, 1.0 / seg.numel(),
            torch.tensor(1.5, device=cuda))
    got = gram.gram_tiles_bwd(*args)
    _assert_scaled_close(got, gram.gram_tiles_bwd_plain(*args), 1e-4)
    if pattern == "masked":
        assert not bool(out.any())
        assert not any(bool(a.any()) for a in got)


@pytest.mark.parametrize("m,k", [(8, 8), (64, 64), (96, 32), (256, 64)])
def test_gram_kernels_any_width_ragged_grid(cuda, m, k):
    """K6a and K6b on 1001 tiles (2002 half-tile chunks, not a multiple of
    the persistent grid) mixing the three segment patterns."""
    from langsplatv2_tpu_torch.ops import gram

    case = gram_pattern_case("warp_segments", m, tiles=1001, seed=5, k=k)
    case["seg"][1::7] = -1
    case["seg"][3::11] = np.random.default_rng(6).permutation(300)[:256]
    lay = m // k - 1
    rhs, gfull = gram.prep(torch.as_tensor(case["codebooks"], device=cuda),
                           torch.as_tensor(case["table"], device=cuda), lay)
    seg = torch.as_tensor(case["seg"], device=cuda)
    w = torch.as_tensor(case["w"], device=cuda)
    torch.testing.assert_close(gram.gram_tiles_fwd(seg, w, rhs, gfull),
                               gram.gram_tiles_fwd_plain(seg, w, rhs, gfull,
                                                         1e-8),
                               rtol=1e-5, atol=1e-3)
    args = (seg, w, rhs, gfull, lay, k, 1e-8, 1.0 / seg.numel(),
            torch.tensor(0.5, device=cuda))
    _assert_scaled_close(gram.gram_tiles_bwd(*args),
                         gram.gram_tiles_bwd_plain(*args), 1e-4)


def test_no_plain_version_on_the_card(cuda, monkeypatch):
    """The wrappers called with CUDA tensors at shapes past the main path's
    designs launch their kernels and never a plain version: every plain
    function is patched to raise, and each wrapper's launch count grows."""
    from langsplatv2_tpu_torch.ops import gram

    def refuse(*_a, **_k):
        raise AssertionError("a plain version ran on CUDA tensors")

    for mod, name in ((query, "query_map_tiles_plain"),
                      (query, "query_map_tiles_bf16_plain"),
                      (blend, "blend_tiles_query_plain"),
                      (blend, "blend_tiles_fast16_plain"),
                      (blend, "blend_tiles_plain"),
                      (gram, "gram_tiles_fwd_plain"),
                      (gram, "gram_tiles_bwd_plain"), (gram, "_chain")):
        monkeypatch.setattr(mod, name, refuse)
    before = {f: f.launches for f in (
        query.query_map_tiles, query.query_map_tiles_bf16,
        blend.blend_tiles_query, gram.gram_tiles_fwd, gram.gram_tiles_bwd)}
    phi, gm = _query_consts(4, 32, 17, cuda, 1)
    wm = torch.rand(5, 256, 128, device=cuda)
    assert query.query_map_tiles(wm, phi, gm)[0].shape == (5, 256, 68)
    query.query_map_tiles(wm.to(torch.bfloat16), phi, gm)
    args, gy, slots, phi8, gram8 = _fused_any_case(cuda, 8, 32, 17, 2)
    blend.blend_tiles_query(*args, gy, slots, phi8, gram8)
    for m, k in ((8, 8), (64, 32), (256, 64)):
        (seg, w, rhs, gfull), lay = _gram_case("warp_segments", m, k, 2, 3,
                                               cuda)
        gram.gram_tiles_fwd(seg, w, rhs, gfull)
        gram.gram_tiles_bwd(seg, w, rhs, gfull, lay, k, 1e-8, 1e-3,
                            torch.tensor(1.0, device=cuda))
    torch.cuda.synchronize()
    grown = {f.__name__: f.launches - n for f, n in before.items()}
    assert grown == {"query_map_tiles": 1, "query_map_tiles_bf16": 1,
                     "blend_tiles_query": 1, "gram_tiles_fwd": 3,
                     "gram_tiles_bwd": 3}, grown


# ------------------------------------------- K1 and K5 on their edge cases
# (tests/torch_port_fixtures.py::expand_edge_case and capped_edge_case;
# tests/test_torch_port_expand_edges.py holds the plain versions to JAX's
# Pallas kernels on the same cases).

EXPAND_FIELDS = ("xy", "depth", "conic", "radius", "rgb", "rect_min",
                 "rect_max", "tiles_touched")
EXPAND_SLOTS = 2048   # csrc/expand.cu's slots a block


def _expand_scene(name: str, dev):
    """The edge scene `name` as CUDA tensors, with its max_entries cuts:
    "live" and "empty" (8 x 6 tiles, one block of slots; in "live" one
    Gaussian's rect is 0 tiles wide with tiles_touched > 0, which both
    versions read as width 1), "wide" (a 1080p grid, 120 x 68 tiles, three
    draws: whole-grid rects of 8,160 tiles over 4-5 blocks, cut mid-rect, on
    block boundaries and one slot on either side), "unit" (6,000 rects of
    one tile, every third of none: a block's slots have ~3,000 owners, more
    than the kernel stages in one pass), "none" (no Gaussian at all)."""
    if name == "none":
        c = expand_edge_case(seed=0, live=False)
        c.update({k: c[k][:0] for k in EXPAND_FIELDS + ("opacities",)})
        c["cuts"] = [37]
    elif name == "unit":
        c = expand_edge_case(seed=4)
        rng = np.random.default_rng(4)
        n = 6000
        lo = np.stack([rng.integers(0, 8, n), rng.integers(0, 6, n)], 1)
        hi = lo + 1
        hi[::3, 0] = lo[::3, 0]
        tiles = ((hi[:, 0] - lo[:, 0]) * (hi[:, 1] - lo[:, 1])).astype(
            np.int32)
        c.update(xy=(lo * 16 + rng.uniform(0, 16, (n, 2))).astype(np.float32),
                 depth=rng.uniform(1, 9, n).astype(np.float32),
                 conic=np.tile(np.float32([0.02, 0.0, 0.02]), (n, 1)),
                 radius=np.where(tiles > 0, 8, 0).astype(np.int32),
                 rgb=np.zeros((n, 3), np.float32),
                 rect_min=lo.astype(np.int32), rect_max=hi.astype(np.int32),
                 tiles_touched=tiles,
                 opacities=rng.uniform(0.1, 0.95, n).astype(np.float32))
        total = int(tiles.sum())
        c["cuts"] = [total + 5, total - 1, EXPAND_SLOTS + 1]
    elif name == "wide":
        c = expand_edge_case(seed=3, grid=(120, 68), copies=3)
        total = int(c["tiles_touched"].sum())
        c["cuts"] += [EXPAND_SLOTS * k + d for k in (1, 4, 9)
                      for d in (-1, 0, 1)] + [total - 1, total]
    else:
        c = expand_edge_case(seed=0, live=name == "live")
        if name == "live":
            c["rect_max"][5, 0] = c["rect_min"][5, 0]
    proj = projection.ProjectedGaussians(*[
        torch.as_tensor(c[k], device=dev) for k in EXPAND_FIELDS])
    return proj, torch.as_tensor(c["opacities"], device=dev), c


def _expand_both(proj, ops, gx, gy, cut, exact_cull, with_alpha):
    out = expand.expand_entries(proj, ops, gx, gy, cut,
                                exact_cull=exact_cull, with_alpha=with_alpha)
    offsets = torch.cumsum(proj.tiles_touched, 0, dtype=torch.int64) \
        - proj.tiles_touched
    ref = expand.expand_entries_plain(proj, ops, offsets, gx, gy, cut,
                                      exact_cull, 255.0, with_alpha)
    return out, ref


@pytest.mark.parametrize("exact_cull,with_alpha",
                         [(False, 0), (True, 0), (True, 1), (True, 2)],
                         ids=["nocull", "cull", "alpha1", "alpha2"])
@pytest.mark.parametrize("scene_name",
                         ["live", "empty", "wide", "unit", "none"])
def test_expand_kernel_edges(cuda, scene_name, exact_cull, with_alpha):
    """K1 against its plain version at every cut: tile, depth, gauss and
    total equal; with_alpha's lm within 2 f32 ulps, 0 where the plain
    version's is, and the lm words equal."""
    proj, ops, c = _expand_scene(scene_name, cuda)
    gx, gy = c["grid_x"], c["grid_y"]
    n_tiles = int(c["tiles_touched"].sum())
    for cut in c["cuts"]:
        out, ref = _expand_both(proj, ops, gx, gy, cut, exact_cull,
                                with_alpha)
        assert int(out[3]) == min(n_tiles, cut), cut
        for a, b in zip(out[:3], ref[:3]):
            assert torch.equal(a, b), cut
        if with_alpha:
            lm, lm_ref = out[4], ref[3]
            assert lm.shape == lm_ref.shape == (with_alpha ** 2, cut)
            assert torch.equal(lm == 0, lm_ref == 0), cut
            assert float(f32_ulps(lm, lm_ref).max()) <= 2.0, cut
            for a, b in zip(budget.pack_lm_words(lm),
                            budget.pack_lm_words(lm_ref)):
                assert torch.equal(a, b), cut


def test_expand_writes_every_slot(cuda, monkeypatch):
    """The wrapper allocates its outputs uninitialised: with every buffer
    it allocates filled with 0xFF bytes first (NaN as f32, -1 as int32:
    a poisoned caching allocator, made deterministic; which freed block
    the allocator hands out depends on what the process allocated
    before), K1 with_alpha must still give total, the dead slots, the
    tail past total and lm's zeros exactly, equal to the plain version."""
    proj, ops, c = _expand_scene("live", cuda)
    gx, gy = c["grid_x"], c["grid_y"]
    cut = (1 << 20) + 37                    # a tail of a million slots
    real_empty, made = torch.empty, []

    def poisoned_empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        t.reshape(-1).view(torch.uint8).fill_(0xFF)
        made.append(t)
        return t

    monkeypatch.setattr(torch, "empty", poisoned_empty)
    out = expand.expand_entries(proj, ops, gx, gy, cut, with_alpha=2)
    monkeypatch.undo()
    assert len(made) == 5, "tile, depth, gauss, total and lm"
    offsets = torch.cumsum(proj.tiles_touched, 0, dtype=torch.int64) \
        - proj.tiles_touched
    ref = expand.expand_entries_plain(proj, ops, offsets, gx, gy, cut, True,
                                      255.0, 2)
    assert int(out[3]) == int(c["tiles_touched"].sum())
    total = int(out[3])
    assert 0 < total < cut
    for a, b in zip(out[:3], ref[:3]):
        assert torch.equal(a, b)
    assert torch.equal(out[4] == 0, ref[3] == 0)
    assert float(f32_ulps(out[4], ref[3]).max()) <= 2.0
    dead = out[0] == gx * gy
    assert bool(dead[total:].all()) and bool(dead[:total].any())
    assert not out[1][dead].any() and not out[2][dead].any()
    assert not out[4][:, dead].any()


@pytest.mark.parametrize("channels", [32, 64])
@pytest.mark.parametrize("topk", [1, 3, 4])
@pytest.mark.parametrize("cap", [64, 128])
def test_feature_bwd_topk_kernel_edges(cuda, cap, topk, channels):
    """K5 against its plain version (1e-5 of the largest output) on the
    capped edge windows; slots at or past kept, after the ending entry and
    of the dark run are exactly 0."""
    c = capped_edge_case(cap, topk, channels, seed=cap + topk + channels)
    t = {k: torch.as_tensor(c[k], device=cuda)
         for k in ("g_win", "kept", "geom", "qi", "cot")}
    gx, gy = c["grid_x"], c["grid_y"]
    args = (t["g_win"], t["kept"], t["geom"], t["qi"], t["cot"])
    out = train.feature_grads_topk(*args, gx, gy, cap)
    ref = train.feature_grads_topk_plain(*args, gx, cap)
    scale = float(ref.abs().max())
    assert scale > 1e-2
    torch.testing.assert_close(out / scale, ref / scale, atol=1e-5, rtol=0)
    zero = torch.arange(cap, device=cuda)[None, :] >= t["kept"][:, None]
    zero[CAPPED_END_TILE, CAPPED_END_AT:] = True
    zero[CAPPED_DARK_TILE, 8:32] = True
    zero = zero.reshape(-1)
    assert float(out[zero].abs().max()) == 0.0
    assert float(out[~zero].abs().max()) > 0.0


# ------------------------------------------------ K8 and K9 on their edges
# (tests/torch_port_fixtures.py::cascade_edge_case; the same scenes are held
# against JAX on the CPU in tests/test_torch_port_cascade_edges.py).

def _cascade_scene(kind: str, dev):
    c = cascade_edge_case(kind)
    proj = projection.ProjectedGaussians(
        *(torch.as_tensor(c[k], device=dev) for k in CASCADE_FIELDS))
    return c, proj, torch.as_tensor(c["opacities"], device=dev)


def _rows_total(c) -> int:
    alive = c["tiles_touched"] > 0
    return int((c["rect_max"][:, 1] - c["rect_min"][:, 1])[alive].sum())


def _cascade_equal(proj, ops, gx, gy, budget):
    out = cascade.cascade_binning(proj, ops, gx, gy, budget)
    ref = cascade.cascade_binning_plain(proj, ops, gx, gy, budget, 255.0)
    for name, a, b in zip(("g", "start", "count", "total", "overflow"), out,
                          ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), f"{name} differs at budget {budget}"
    return out


@pytest.mark.parametrize("kind", CASCADE_EDGES)
def test_cascade_kernel_edges(cuda, kind):
    """K8 equal to its plain version, every output, at the budget edges of
    tests/torch_port_fixtures.py::cascade_budgets: overflow at level 0 only
    ("level0") and at level 1 only ("level1"), grid_x 1 ("column") and
    1,024 ("widest"), rects wider than the 64 tiles the keep bits cover
    ("wide", "widest"), rows of exactly 255, 256, 257 and 512 items and
    1,280 Gaussians ("chunks"), no live Gaussian and none at all."""
    c, proj, ops = _cascade_scene(kind, cuda)
    gx, gy = c["grid_x"], c["grid_y"]
    full = _cascade_equal(proj, ops, gx, gy, 1 << 17)
    assert not bool(full[4])
    rows_total = _rows_total(c)
    budgets = cascade_budgets(kind, rows_total, full[2].cpu().numpy())
    flags = {b: bool(_cascade_equal(proj, ops, gx, gy, b)[4])
             for b in budgets}
    least = max(int(full[3]), rows_total)
    assert flags[least] is False
    if kind not in ("dead", "none"):
        assert flags[least - 1] is True
    if kind == "level0":
        assert flags[rows_total - 1] is True
    if kind == "level1":
        assert rows_total < int(full[3]) and flags[rows_total] is True
    if kind in ("wide", "widest"):
        width = c["rect_max"][:, 0] - c["rect_min"][:, 0]
        assert (width > 64).any() and int(full[3]) > 0


def test_cascade_writes_every_slot(cuda, monkeypatch):
    """The wrapper allocates its workspace and outputs uninitialised: with
    every buffer it allocates filled with 0xFF bytes first, K8 must still
    give every output of the plain version exactly (the ids past the total
    zero), at a budget with a tail past the total and at one that cuts both
    levels."""
    real_empty, made = torch.empty, []

    def poisoned_empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        t.reshape(-1).view(torch.uint8).fill_(0xFF)
        made.append(t)
        return t

    for kind in ("chunks", "wide"):
        c, proj, ops = _cascade_scene(kind, cuda)
        gx, gy = c["grid_x"], c["grid_y"]
        full = cascade.cascade_binning(proj, ops, gx, gy, 1 << 17)
        for budget in (int(full[3]) + 4099, int(full[3]) // 2):
            made.clear()
            monkeypatch.setattr(torch, "empty", poisoned_empty)
            out = cascade.cascade_binning(proj, ops, gx, gy, budget)
            monkeypatch.undo()
            assert len(made) == 6, "workspace, g, start, count, total, flag"
            ref = cascade.cascade_binning_plain(proj, ops, gx, gy, budget,
                                                255.0)
            for a, b in zip(out, ref):
                assert torch.equal(a, b)
            assert not bool(out[0][int(out[3]):].any())


def _device_ops(fn) -> int:
    """Kernels and memory operations one call of fn puts on the device."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def test_cascade_launches_a_call(cuda):
    """One K8 call puts cascade.LAUNCHES operations on the device besides
    torch.sort's depth sort (the same sort of an int32 key of the same
    length, profiled alone), and reads nothing back to the host."""
    proj, ops, gx, gy = _case(cuda)
    n = proj.depth.shape[0]
    keys = torch.randint(0, 1 << 30, (n,), dtype=torch.int32, device=cuda)
    sort_ops = _device_ops(lambda: torch.sort(keys, stable=True))
    call_ops = _device_ops(lambda: cascade.cascade_binning(
        proj, ops, gx, gy, 2 ** 17))
    assert sort_ops > 0
    assert call_ops - sort_ops == cascade.LAUNCHES, (call_ops, sort_ops)


def test_cell_chain_bf16_fallback(cuda):
    """K9 bf16's exp fallback. Its exp alone (mode EXP_ONLY) on the s in
    [0, 2) whose expf(-s) lies within 4 f32 steps of a bf16 rounding
    midpoint (the approximation is within 12 steps of expf, so each takes
    the fallback), beside s = 1/2, equals torch's bf16 exp and counts a
    fallback for each. No such s is the bf16 square of a bf16 value, so the
    chain meets none: there, pairs with a lane whose s passes 2 (x near 3)
    run the chain again with expf, and the output equals the plain version
    element for element, in bf16 and in f32."""
    s = torch.arange(0, 0x4000, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).to(cuda)
    low = torch.exp(-s.float()).view(torch.int32) & 0xFFFF
    near = s[(low - 0x8000).abs() <= 4]
    assert near.numel() > 0
    pairs = torch.stack([near, torch.full_like(near, 0.5)], 1).reshape(-1)
    out, fell_back = probe.kernel_mode(pairs.float(), probe.EXP_ONLY)
    assert torch.equal(out, torch.exp(-pairs).float())
    assert fell_back == near.numel()
    gen = torch.Generator(device=cuda).manual_seed(3)
    big = 2.9 + 0.4 * torch.rand(3000, generator=gen, device=cuda)
    small = torch.rand(3000, generator=gen, device=cuda) * 2 - 1
    x = torch.stack([big, small], 1).reshape(-1)
    out, fell_back = probe.kernel_mode(x, 1)
    assert fell_back == 3000
    ref = probe.cell_chain_plain(x, torch.bfloat16)
    assert int((out != ref).sum()) == 0
    assert torch.equal(probe.cell_chain(x, torch.float32),
                       probe.cell_chain_plain(x, torch.float32))


def test_bf16_exp_on_every_bf16_input(cuda):
    """The bf16 kernel's exp (ex2.approx where it provably rounds as expf
    does, expf elsewhere) against torch's bf16 exp on every non-negative
    bf16 s, NaNs and infinity included: equal bit for bit (NaN where
    torch's is NaN); the fallback is taken for s >= 2 and near
    midpoints."""
    s = torch.arange(0, 1 << 15, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).to(cuda)
    out, fell_back = probe.kernel_mode(s.float(), probe.EXP_ONLY)
    want = torch.exp(-s).float()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan], want[~nan])
    outside = (s.float() >= 2) | torch.isnan(s)
    assert fell_back >= int(outside.reshape(-1, 2).any(1).sum())


@pytest.mark.parametrize("n", [2, 2 * 257, 2 * 256 * 3 + 2])
def test_cell_chain_small_and_ragged(cuda, n):
    """K9 at n = 2 (one bf16 pair) and at odd pair counts over several
    256-thread blocks: both forms equal their plain versions element for
    element."""
    x = torch.rand(n, generator=torch.Generator().manual_seed(n)) * 2 - 1
    x = x.to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        out = probe.cell_chain(x, dtype)
        ref = probe.cell_chain_plain(x, dtype)
        assert out.shape == (n,) and int((out != ref).sum()) == 0



# ------------------------------------------- training from a scene directory

def test_native_loader_matches_numpy_path(cuda, tmp_path):
    """The port's native loader (its C++ copy built with the host's g++
    into build/) against Camera.get_language_feature's numpy path, at the
    map's size and resized by 3."""
    from langsplatv2_tpu_torch import native
    from langsplatv2_tpu_torch.scene.cameras import Camera

    assert native.available(), "the host g++ did not build the loader"
    rng = np.random.default_rng(0)
    np.save(tmp_path / "a_s.npy", rng.integers(-1, 9, (4, 24, 31)).astype(
        np.int32))
    np.save(tmp_path / "a_f.npy", rng.normal(size=(9, 512)).astype(
        np.float16))
    for h, w in ((24, 31), (72, 93)):
        cam = Camera(0, np.eye(3), np.zeros(3), 1.0, 0.8, None, "a", 0, w, h)
        got = native.load_language_feature(
            str(tmp_path / "a_s.npy"), str(tmp_path / "a_f.npy"), 2, h, w)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(native, "load_language_feature", lambda *a, **k: None)
            ref = cam.get_language_feature(str(tmp_path), 2)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_cli_trains_both_phases_on_the_card(cuda, tmp_path):
    """python -m langsplatv2_tpu_torch.train.cli's main on a tiny COLMAP
    scene with the default device: the geometry phase (K1, K2, K7), then the
    feature phase from its checkpoint (k-means codebooks; K1, K2, K4, K6a,
    K6b), finite losses, the checkpoints written."""
    import io
    import sys

    from langsplatv2_tpu_torch.ops import gram, rgb_train
    from langsplatv2_tpu_torch.train import cli

    from torch_port_fixtures import write_colmap_scene

    write_colmap_scene(tmp_path / "scene", np.random.default_rng(0))
    wrappers = {"K1": expand.expand_entries, "K2": blend.blend_tiles,
                "K4": train.feature_grads, "K6a": gram.gram_tiles_fwd,
                "K6b": gram.gram_tiles_bwd, "K7": rgb_train.rgb_grads}
    out = str(tmp_path / "out" / "m")
    base = ["-s", str(tmp_path / "scene"), "-m", out, "--max_entries",
            "65536", "--test_iterations", "6", "--quiet"]
    counts = {}
    stdout = sys.stdout
    try:
        for phase, extra in (("rgb", ["--iterations", "6"]),
                             ("feature", ["--iterations", "6",
                                          "--include_feature",
                                          "--start_checkpoint",
                                          f"{out}_-1/chkpnt6.npz",
                                          "--feature_level", "1",
                                          "--cos_loss", "--topk", "4",
                                          "--codebook_size", "16"])):
            for w in wrappers.values():
                w.launches = 0
            sys.stdout = io.StringIO()
            summary = cli.main(base + extra)
            torch.cuda.synchronize()
            counts[phase] = {k: w.launches for k, w in wrappers.items()}
            assert np.isfinite(summary["losses"]).all(), phase
    finally:
        sys.stdout = stdout
    assert all(counts["rgb"][k] >= 6 for k in ("K1", "K2", "K7")), counts
    assert all(counts["feature"][k] >= 6
               for k in ("K1", "K2", "K4", "K6a", "K6b")), counts
    assert counts["feature"]["K7"] == 0
    import os
    assert os.path.exists(f"{out}_1/chkpnt6.npz")


def test_cam_batch_matches_accum_on_the_card(cuda):
    """cam_batch = 3 against accum_iter = 3 on the card, exact and capped
    routes: logits and codebooks at atol 3e-5, losses at rtol 3e-5 / atol
    1e-6 (tests/test_training.py's tolerances)."""
    import types

    from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
    from langsplatv2_tpu_torch.train import trainer

    from torch_port_fixtures import two_camera_feature_scene

    fields, cams = two_camera_feature_scene()
    opt = types.SimpleNamespace(language_feature_lr=0.01)
    for extra in ({}, dict(tile_budget=1e-6, tile_budget_cap=128)):
        runs = []
        for mode in (dict(accum_iter=3), dict(cam_batch=3)):
            model, _, logs = trainer.train_features(
                from_numpy_params(fields, active_sh_degree=0, device=cuda),
                cams, opt, "", 1, iterations=7, topk=4, max_entries=2 ** 14,
                seed=11, feature_cache={}, device=cuda, **mode, **extra)
            runs.append((model, logs))
        (m_seq, l_seq), (m_bat, l_bat) = runs
        for name in ("language_logits", "codebooks"):
            torch.testing.assert_close(getattr(m_bat, name),
                                       getattr(m_seq, name), atol=3e-5,
                                       rtol=0)
        np.testing.assert_allclose(l_bat.losses, l_seq.losses, rtol=3e-5,
                                   atol=1e-6)
        assert not torch.equal(m_seq.codebooks.cpu(), torch.from_numpy(
            fields["codebooks"]))
