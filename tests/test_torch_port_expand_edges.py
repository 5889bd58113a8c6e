"""K1 and K5 on their edge cases, the port's plain versions against the JAX
package's Pallas kernels (interpret mode).

K1  ops/expand.py::expand_entries(device="cpu") vs
    pallas_binning.expand_entries_pallas, without and with with_alpha, on
    tests/torch_port_fixtures.py::expand_edge_case: a whole-grid rect, runs
    of zero-tile Gaussians, max_entries cutting the first live rect in the
    middle, on either side of a rect boundary and past the total, and a
    scene with no live entry.
K5  ops/train.py::feature_grads_topk_plain vs feature_grads_topk_pallas on
    capped_edge_case: kept counts on the batch edges, a full window, a
    window whose every pixel ends mid-batch, a dark run of entries.

tests/test_torch_port_gpu.py holds the card's kernels to these plain
versions on the same cases, so this file closes the chain from the card to
the JAX package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.ops import pallas_binning, pallas_blend
from langsplatv2_tpu.ops import projection as jax_projection
from langsplatv2_tpu.ops.pallas_train import feature_grads_topk_pallas
from langsplatv2_tpu_torch.ops import expand, train
from langsplatv2_tpu_torch.ops.projection import ProjectedGaussians

from torch_port_fixtures import (CAPPED_DARK_TILE, CAPPED_END_AT,
                                 CAPPED_END_TILE, capped_edge_case,
                                 expand_edge_case)

PROJ_FIELDS = ("xy", "depth", "conic", "radius", "rgb", "rect_min",
               "rect_max", "tiles_touched")


@pytest.fixture(scope="module", params=[True, False], ids=["live", "empty"])
def edge_scene(request):
    c = expand_edge_case(seed=0, live=request.param)
    c["proj_t"] = ProjectedGaussians(*[torch.from_numpy(c[k])
                                       for k in PROJ_FIELDS])
    c["proj_j"] = jax_projection.ProjectedGaussians(*[jnp.asarray(c[k])
                                                      for k in PROJ_FIELDS])
    return c


# (exact_cull, with_alpha): K1 without the cull, with it, and its two
# with_alpha modes (which need the cull).
MODES = [(False, 0), (True, 0), (True, 1), (True, 2)]


@pytest.mark.parametrize("exact_cull,with_alpha", MODES,
                         ids=["nocull", "cull", "alpha1", "alpha2"])
def test_expand_edges_match_pallas(edge_scene, exact_cull, with_alpha):
    """At every max_entries cut: tile, depth, gauss and total equal; lm 0
    exactly where JAX's is (culled and dead slots) and elsewhere within
    test_torch_port_alpha.py's 1e-5 relative: XLA:CPU's own jit and
    interpret forms of the sub-box bound sit up to ~11 ulps apart, so the
    2-ulp limit holds between the card's kernel and the plain version
    (tests/test_torch_port_gpu.py), not against JAX."""
    c = edge_scene
    gx, gy = c["grid_x"], c["grid_y"]
    ops = c["opacities"]
    first = None
    for cut in c["cuts"]:
        out = expand.expand_entries(c["proj_t"], torch.from_numpy(ops), gx,
                                    gy, cut, exact_cull=exact_cull,
                                    with_alpha=with_alpha)
        ref = pallas_binning.expand_entries_pallas(
            c["proj_j"], gx, gy, cut, opacities=jnp.asarray(ops),
            exact_cull=exact_cull, with_alpha=with_alpha, interpret=True)
        first = out if first is None else first
        assert int(out[3]) == int(ref[3]) == min(
            int(c["tiles_touched"].sum()), cut), cut
        for a, b in zip(out[:3], ref[:3]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"max_entries {cut}")
        if not with_alpha:
            continue
        lm, lm_j = out[4].numpy(), np.stack([np.asarray(a) for a in ref[4:]])
        assert lm.shape == lm_j.shape == (with_alpha ** 2, cut)
        np.testing.assert_array_equal(lm == 0, lm_j == 0)
        err = np.abs(lm - lm_j)
        assert (err <= 1e-5 * np.abs(lm_j) + 1e-37).all(), cut
    if exact_cull and c["tiles_touched"].any():
        kept = first[0].numpy()[:int(first[3])] < gx * gy
        assert kept.any() and not kept.all(), \
            "the case should keep some entries and cull others"


@pytest.mark.parametrize("channels", [32, 64])
@pytest.mark.parametrize("topk", [2, 4])
def test_feature_grads_topk_edges_match_pallas(topk, channels):
    """K5's plain version against feature_grads_topk_pallas on the capped
    edge windows at cap 128, within 1e-5 of the largest output (the
    port's weights are K2's running product, the Pallas kernel's an
    exclusive cumprod); slots at or past kept, after the ending entry and
    of the dark run are 0 in both. The Pallas kernel takes only even topk
    <= 4 (its f32 row packs index pairs) and caps that are multiples of
    128: topk 1 and 3 and cap 64 are held between the plain version and
    the card's kernel in tests/test_torch_port_gpu.py only."""
    cap = 128
    c = capped_edge_case(cap, topk, channels, seed=topk + channels)
    gx, gy = c["grid_x"], c["grid_y"]
    t = {k: torch.from_numpy(c[k]) for k in ("g_win", "kept", "geom", "qi",
                                             "cot")}
    out = train.feature_grads_topk(t["g_win"], t["kept"], t["geom"],
                                   t["qi"], t["cot"], gx, gy, cap).numpy()
    g = c["geom"]
    rows = pallas_blend.pack_quick_train_rows(
        jnp.asarray(g[:, 0:2]), jnp.asarray(g[:, 2:5]), jnp.asarray(g[:, 5]),
        jnp.asarray(g[:, 6:9]), jnp.asarray(c["qw"]),
        jnp.asarray(c["qi"], jnp.float32))[jnp.asarray(c["g_win"])]
    ref = feature_grads_topk_pallas(
        pallas_blend.to_field_major(rows, cap), jnp.asarray(c["kept"]),
        jnp.arange(gx * gy, dtype=jnp.int32), jnp.asarray(c["cot"]),
        grid_x=gx, grid_y=gy, feat_k=channels, topk=topk, cap=cap,
        interpret=True)
    ref = np.asarray(ref)[:topk, :gx * gy * cap].T
    scale = float(np.abs(ref).max())
    assert scale > 1e-2
    np.testing.assert_allclose(out / scale, ref / scale, atol=1e-5)
    zero = (np.arange(cap)[None, :] >= c["kept"][:, None])
    zero[CAPPED_END_TILE, CAPPED_END_AT:] = True
    zero[CAPPED_DARK_TILE, 8:32] = True
    zero = zero.reshape(-1)
    assert not out[zero].any() and not ref[zero].any()
    assert out[~zero].any(axis=1).mean() > 0.5
