"""Parity of the port's kernel modules with the JAX Pallas kernels.

K1 langsplatv2_tpu_torch/ops/expand.py  vs pallas_binning.expand_entries_pallas
K2 langsplatv2_tpu_torch/ops/blend.py   vs pallas_blend.blend_tiles_pallas (f32)
K3 langsplatv2_tpu_torch/ops/query.py   vs pallas_query.query_map_tiles
The JAX side runs in interpret mode on the CPU, as its own tests run it;
the port runs each kernel's plain version (CPU tensors). Inputs are the
same float32 arrays on both sides. tests/test_torch_port_gpu.py holds each
CUDA kernel against its plain version on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from langsplatv2_tpu.ops import binning, pallas_binning, pallas_blend, \
    projection
from langsplatv2_tpu.ops.pallas_query import query_map_tiles as jax_query
from langsplatv2_tpu_torch.ops import blend, expand, query
from langsplatv2_tpu_torch.ops.projection import ProjectedGaussians

from torch_port_fixtures import camera, quick_pairs, scene


def _jax_proj(n, h, w, seed, with_opacity):
    sc = scene(n, seed)
    view, pm, tfx, tfy = camera(h, w)
    ops = sc["opacities"][:, 0]
    proj = projection.preprocess(
        jnp.asarray(sc["means"]), jnp.asarray(sc["scales"]),
        jnp.asarray(sc["rotations"]), None, None, jnp.asarray(sc["colors"]),
        jnp.asarray(view), jnp.asarray(pm), jnp.zeros(3, jnp.float32),
        tfx, tfy, w, h, 0, 1.0,
        opacities=jnp.asarray(ops) if with_opacity else None)
    return proj, ops


def _to_torch(proj) -> ProjectedGaussians:
    return ProjectedGaussians(*[
        None if a is None else torch.from_numpy(np.array(a)) for a in proj])


@pytest.mark.parametrize("exact_cull", [False, True])
def test_expand_matches_pallas(exact_cull):
    h, w = 128, 160
    proj, ops = _jax_proj(3000, h, w, seed=1, with_opacity=exact_cull)
    gx, gy = -(-w // 16), -(-h // 16)
    num_tiles = gx * gy
    me = 2 ** 15
    tile_j, depth_j, gauss_j, total_j = pallas_binning.expand_entries_pallas(
        proj, gx, gy, me, opacities=jnp.asarray(ops) if exact_cull else None,
        exact_cull=exact_cull, interpret=True)
    keys = pallas_binning.pack_sort_keys(tile_j, depth_j, gauss_j, num_tiles)
    g_j, start_j, count_j, _ = pallas_binning.sorted_binning_from_keys(
        keys, num_tiles)

    tile, depth, gauss, total = expand.expand_entries(
        _to_torch(proj), torch.from_numpy(ops), gx, gy, me,
        exact_cull=exact_cull)
    assert int(total) == int(total_j)
    np.testing.assert_array_equal(tile.numpy(), np.asarray(tile_j))
    np.testing.assert_array_equal(gauss.numpy(), np.asarray(gauss_j))
    np.testing.assert_array_equal(depth.numpy(), np.asarray(depth_j))
    g_sorted, start, count = expand.sort_entries(tile, depth, gauss,
                                                 num_tiles)
    np.testing.assert_array_equal(start.numpy(), np.asarray(start_j))
    np.testing.assert_array_equal(count.numpy(), np.asarray(count_j))
    live = int(count.sum())
    if exact_cull:
        assert live < int(total), "the exact cull should drop entries"
    np.testing.assert_array_equal(g_sorted[:live].numpy(),
                                  np.asarray(g_j)[:live])


def test_expand_overflow_clamps_to_budget():
    proj, ops = _jax_proj(2000, 64, 64, seed=2, with_opacity=True)
    tile, depth, gauss, total = expand.expand_entries(
        _to_torch(proj), torch.from_numpy(ops), 4, 4, 512)
    _, _, _, total_j = pallas_binning.expand_entries_pallas(
        proj, 4, 4, 512, opacities=jnp.asarray(ops), exact_cull=True,
        interpret=True)
    assert int(total) == int(total_j) == 512
    assert tile.shape == (512,)


@pytest.fixture(scope="module")
def blend_case():
    """500 splats at 64x96, XLA-binned, with merged quick pairs."""
    h, w = 64, 96
    proj, ops = _jax_proj(500, h, w, seed=0, with_opacity=False)
    gx, gy = -(-w // 16), -(-h // 16)
    binned = binning.bin_gaussians(proj, gx, gy, 2 ** 13)
    qw, qi = quick_pairs(proj.xy.shape[0])
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    geom = blend.pack_gaussian_state(
        torch.from_numpy(np.array(proj.xy)),
        torch.from_numpy(np.array(proj.conic)), torch.from_numpy(ops),
        torch.from_numpy(np.array(proj.rgb)))
    return dict(proj=proj, ops=ops, binned=binned, gx=gx, gy=gy, bg=bg,
                qw=qw, qi=qi, geom=geom)


def _jax_blend(c, mode, starts=None, counts=None):
    proj, binned = c["proj"], c["binned"]
    g = binned.gauss_id
    tid = jnp.arange(c["gx"] * c["gy"], dtype=jnp.int32)
    starts = binned.tile_start if starts is None else jnp.asarray(starts)
    counts = binned.tile_count if counts is None else jnp.asarray(counts)
    if mode == "quick":
        rows, wrows = pallas_blend.pack_quick_rows(
            proj.xy, proj.conic, jnp.asarray(c["ops"]), proj.rgb,
            jnp.asarray(c["qw"]), jnp.asarray(c["qi"]))
        feat = pallas_blend.to_field_major(wrows[g], 256)
        kw = dict(mode="quick", out_channels=192, topk=12)
    else:
        rows = pallas_blend.pack_gaussian_rows(
            proj.xy, proj.conic, jnp.asarray(c["ops"]), proj.rgb)
        feat = None
        kw = dict(mode="rgb", out_channels=0)
    geom = pallas_blend.to_field_major(rows[g], 256)
    if feat is None:
        feat = jnp.zeros((1, geom.shape[1]), jnp.float32)
    return pallas_blend.blend_tiles_pallas(
        geom, feat, starts, counts, tid, jnp.asarray(c["bg"]),
        grid_x=c["gx"], grid_y=c["gy"], chunk=256, rowfmt="f32",
        interpret=True, **kw)


def _port_blend(c, mode, starts=None, counts=None):
    binned = c["binned"]
    args = (torch.from_numpy(np.array(binned.gauss_id)),
            torch.from_numpy(np.array(
                binned.tile_start if starts is None else starts)),
            torch.from_numpy(np.array(
                binned.tile_count if counts is None else counts)),
            c["geom"], torch.from_numpy(c["bg"]), c["gx"], c["gy"])
    if mode == "quick":
        return blend.blend_tiles(
            *args, torch.from_numpy(c["qw"]),
            torch.from_numpy(c["qi"].astype(np.int32)), 192)
    return blend.blend_tiles(*args)


@pytest.mark.parametrize("mode", ["quick", "rgb"])
def test_blend_matches_pallas(blend_case, mode):
    # Product order of T differs (sequential vs chunked scan), as between
    # the Pallas kernel and the XLA blend: atol 3e-5.
    rgb_j, feat_j, t_j = _jax_blend(blend_case, mode)
    rgb, feat, t = _port_blend(blend_case, mode)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=3e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=3e-5)
    if mode == "quick":
        assert feat.shape == (blend_case["gx"] * blend_case["gy"], 256, 192)
        np.testing.assert_allclose(feat.numpy(), np.asarray(feat_j),
                                   atol=3e-5)
        assert float(np.abs(feat.numpy()).max()) > 0.1
    else:
        assert feat is None


def test_blend_empty_tile_with_misaligned_start(blend_case):
    """A tile with count 0 whose start is not 128-aligned renders pure
    background (the Pallas kernel's hang regression)."""
    starts = np.asarray(blend_case["binned"].tile_start).copy()
    counts = np.asarray(blend_case["binned"].tile_count).copy()
    v = int(np.nonzero((starts % 128 != 0) & (counts > 0))[0][0])
    counts[v] = 0
    rgb_j, _, t_j = _jax_blend(blend_case, "rgb", starts, counts)
    rgb, _, t = _port_blend(blend_case, "rgb", starts, counts)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_j), atol=3e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), atol=3e-5)
    np.testing.assert_allclose(rgb[v].numpy(),
                               np.tile(blend_case["bg"], (256, 1)), atol=1e-6)
    np.testing.assert_allclose(t[v].numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("t,levels,pq,tile_batch", [(5, 3, 7, 2),
                                                    (7, 1, 3, 4)])
def test_query_matches_pallas(t, levels, pq, tile_batch):
    """f32 map, L=3 and L=1, tile counts not divisible by the Pallas tile
    batch (tests/test_pallas_query.py cases and tolerances)."""
    rng = np.random.default_rng(levels)
    wm = rng.standard_normal((t, 256, levels * 64)).astype(np.float32)
    phi = rng.standard_normal((levels, 64, pq)).astype(np.float32)
    cb = rng.standard_normal((levels, 64, 32)).astype(np.float32)
    gram = np.einsum("lkd,lmd->lkm", cb, cb).astype(np.float32)
    raw_j, nrm2_j = jax_query(jnp.asarray(wm), jnp.asarray(phi),
                              jnp.asarray(gram), tile_batch=tile_batch,
                              interpret=True)
    raw, nrm2 = query.query_map_tiles(torch.from_numpy(wm),
                                      torch.from_numpy(phi),
                                      torch.from_numpy(gram))
    assert raw.shape == (t, 256, levels * pq) and nrm2.shape == (t, 256, levels)
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nrm2.numpy(), np.asarray(nrm2_j), rtol=1e-5,
                               atol=1e-5)
