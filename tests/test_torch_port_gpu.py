"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device. This file imports neither jax nor the JAX
package, so it also runs on a machine that has only torch:

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q

(tests/conftest.py imports jax, hence --noconftest there).
"""
import numpy as np
import pytest
import torch

from langsplatv2_tpu_torch.ops import blend, expand, query
from langsplatv2_tpu_torch.ops import projection

from torch_port_fixtures import camera, quick_pairs, scene


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
