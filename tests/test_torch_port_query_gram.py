"""The plain versions of K6b (Gram-loss backward) and bf16 K3 (the Gram
query on a bf16 map) against the JAX Pallas kernels, in interpret mode on
the CPU, on the inputs the redesigned CUDA kernels treat apart:

- K6b (langsplatv2_tpu_torch/ops/gram.py::gram_tiles_bwd_plain against
  pallas_gram._gram_bwd_pallas) at M = 64, 128 and 192 on tiles whose
  segments fill whole warps (two pixel rows) with ~5% -1 holes, on a tile
  of -1 only and on a tile of 256 distinct ids: the kernel's d_phi groups
  a warp's pixels by segment and leaves -1 pixels out;
- bf16 K3 (ops/query.py::query_map_tiles_bf16_plain against
  pallas_query.query_map_tiles on the bf16 map) at PQ = 1 and 16, T = 1
  and 3.

Tolerances are the existing ones: the Gram gradients scale-normalized at
5e-6 (tests/test_torch_port_train.py), the query rtol/atol 1e-5
(tests/test_torch_port_kernels.py). tests/test_torch_port_gpu.py holds the
CUDA kernels against these plain versions on the same patterns.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.ops.pallas_gram import _gram_bwd_pallas
from langsplatv2_tpu.ops.pallas_query import query_map_tiles as jax_query
from langsplatv2_tpu_torch.ops import gram, query

from torch_port_fixtures import GRAM_PATTERNS, gram_pattern_case

K = 64


@pytest.mark.parametrize("pattern", GRAM_PATTERNS)
@pytest.mark.parametrize("m", [64, 128, 192])
def test_gram_bwd_plain_matches_pallas_on_segment_patterns(m, pattern):
    case = gram_pattern_case(pattern, m, seed=m)
    lay = m // K - 1
    rhs, gfull = gram.prep(torch.from_numpy(case["codebooks"]),
                           torch.from_numpy(case["table"]), lay)
    inv_hw = 1.0 / 256
    dw, dphi, dg = gram.gram_tiles_bwd_plain(
        torch.from_numpy(case["seg"]), torch.from_numpy(case["w"]), rhs,
        gfull, lay, K, 1e-8, inv_hw, torch.tensor(1.0))
    want = _gram_bwd_pallas(
        jnp.asarray(case["seg"]), jnp.asarray(case["w"]),
        jnp.asarray(rhs.numpy()), jnp.asarray(gfull.numpy()), lay=lay,
        k_l=K, tb=1, eps=1e-8, inv_hw=inv_hw, interpret=True)
    for got, ref in zip((dw, dphi, dg), want):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        sc = max(1e-30, float(np.abs(ref).max()))
        np.testing.assert_allclose(got.numpy() / sc, ref / sc, atol=5e-6)
    if pattern == "masked":
        # No pixel is valid: nothing reaches d_phi, d_w or d_G.
        assert not dphi.any() and not dw.any() and not dg.any()
    else:
        assert dphi.abs().max() > 0 and dg.abs().max() > 0
    keep = np.zeros(m, bool)
    keep[lay * K:] = True
    assert not dw[..., ~keep].any()


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("pq", [1, 16])
def test_query_bf16_plain_matches_pallas(t, pq):
    rng = np.random.default_rng(10 * t + pq)
    levels = 3
    wm = torch.from_numpy(rng.standard_normal(
        (t, 256, levels * K)).astype(np.float32)).to(torch.bfloat16)
    phi = rng.standard_normal((levels, K, pq)).astype(np.float32)
    cb = rng.standard_normal((levels, K, 32)).astype(np.float32)
    gm = np.einsum("lkd,lmd->lkm", cb, cb).astype(np.float32)
    raw, nrm2 = query.query_map_tiles_bf16_plain(wm, torch.from_numpy(phi),
                                                 torch.from_numpy(gm))
    raw_j, nrm2_j = jax_query(jnp.asarray(wm.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(phi), jnp.asarray(gm), tile_batch=2,
        interpret=True)
    assert raw.shape == (t, 256, levels * pq) and nrm2.shape == (t, 256,
                                                                 levels)
    np.testing.assert_allclose(raw.numpy(), np.asarray(raw_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(nrm2.numpy(), np.asarray(nrm2_j), rtol=1e-5,
                               atol=1e-5)
    # The CPU wrapper takes the same plain version for a bf16 map.
    out = query.query_map_tiles(wm, torch.from_numpy(phi),
                                torch.from_numpy(gm))
    assert torch.equal(out[0], raw) and torch.equal(out[1], nrm2)
