"""The training backwards' plain versions against the JAX package's Pallas
kernels (interpret mode) on tiles cut around the port's batch and group
edges (tests/torch_port_fixtures.py::bwd_edge_case): K4's
`feature_grads_plain` against `feature_grads_pallas`, K7's
`rgb_grads_plain` against `rgb_grads_pallas`.

tests/test_torch_port_gpu.py holds the CUDA kernels to these plain
versions on the same tiles, so this file closes the chain from the card's
kernels to the JAX package. Port side: CPU tensors, so every wrapper runs
its plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.ops import pallas_blend, pallas_rgb_train
from langsplatv2_tpu.ops.pallas_train import GRAD_W, feature_grads_pallas
from langsplatv2_tpu_torch.ops import blend, rgb_train, train

from torch_port_fixtures import (BWD_DARK_TILE, BWD_END_AT, BWD_END_TILE,
                                 bwd_edge_case)


@pytest.fixture(scope="module")
def case():
    c = bwd_edge_case(seed=0)
    c["t"] = [torch.from_numpy(c[k]) for k in ("g", "start", "count",
                                               "geom")]
    # The Pallas kernels' field-major rows of the sorted entries.
    rows = pallas_blend.pack_gaussian_rows(
        jnp.asarray(c["geom"][:, 0:2]), jnp.asarray(c["geom"][:, 2:5]),
        jnp.asarray(c["geom"][:, 5]), jnp.asarray(c["geom"][:, 6:9]))
    c["entry_geom"] = pallas_blend.to_field_major(
        rows[jnp.asarray(c["g"])], 256)
    c["tile_ids"] = jnp.arange(c["grid_x"] * c["grid_y"], dtype=jnp.int32)
    return c


def _scaled_close(port, ref, atol):
    scale = float(np.abs(ref).max())
    assert scale > 1e-2
    np.testing.assert_allclose(port / scale, ref / scale, atol=atol)


def _zero_rows(out, c):
    """The rows of the entries after every pixel of the ending tile ended
    and of the entries no pixel of the dark tile includes."""
    s, n = int(c["start"][BWD_END_TILE]), int(c["count"][BWD_END_TILE])
    d = int(c["start"][BWD_DARK_TILE])
    return np.concatenate([out[s + BWD_END_AT:s + n], out[d + 8:d + 32]])


@pytest.mark.parametrize("ch", [13, 64, GRAD_W])
def test_feature_grads_plain_matches_pallas(case, ch):
    """dF rows of every tile's range within 1e-5 of the largest (the
    Pallas kernel's weights are an exclusive cumprod in log space, the
    port's K2's running product); C up to the Pallas kernel's GRAD_W.
    Rows past the last tile's range and of entries no pixel weighs are
    0."""
    c = case
    gx, gy = c["grid_x"], c["grid_y"]
    cot = np.random.default_rng(ch).standard_normal(
        (gx * gy, 256, ch)).astype(np.float32)
    out = train.feature_grads(*c["t"], torch.from_numpy(cot), gx, gy).numpy()
    n = int(c["count"].sum())
    assert out.shape == (c["g"].shape[0], ch) and out.shape[0] > n
    ref = feature_grads_pallas(
        c["entry_geom"], jnp.asarray(c["start"]), jnp.asarray(c["count"]),
        c["tile_ids"], jnp.asarray(cot), grid_x=gx, grid_y=gy, feat_k=ch,
        interpret=True)
    ref = np.asarray(ref)[:n, :ch]
    _scaled_close(out[:n], ref, 1e-5)
    assert not out[n:].any() and not _zero_rows(out, c).any()


def test_rgb_grads_plain_matches_pallas(case):
    """K7's rows within 1e-5 of the largest against rgb_grads_pallas, with
    the port's pack (its forward colour and final T, random cotangents);
    rows of entries no pixel includes, or after every pixel ended, are 0.
    The ending tile's rows from the entry that ends every pixel on are held
    apart: a pixel stops at its end in the port, as in K2, where the Pallas
    kernel adds -suffix / (1 - alpha) for that entry and every later valid
    one, the suffix being the rounding noise of sdot minus the full prefix;
    there JAX's rows are that noise, below 1e-4 of the largest."""
    c = case
    gx, gy = c["grid_x"], c["grid_y"]
    g, start, count, geom = c["t"]
    rgb_t, _, t_t = blend.blend_tiles_plain(g, start, count, geom,
                                            torch.zeros(3), gx)
    rng = np.random.default_rng(7)
    g_rgb = torch.from_numpy(rng.standard_normal(
        (gx * gy, 256, 3)).astype(np.float32))
    g_t = torch.from_numpy(rng.standard_normal(
        (gx * gy, 256)).astype(np.float32))
    pack = rgb_train.make_pack(rgb_t, t_t, g_rgb, g_t)
    out = rgb_train.rgb_grads(g, start, count, geom, pack, gx, gy).numpy()
    n = int(count.sum())
    assert out.shape == (n, 9)
    # The Pallas kernel's pack (pallas_rgb_train.py:366-370): gT and
    # T_final apart, two pad columns.
    jpack = torch.cat([pack[..., :4], g_t[..., None], t_t[..., None],
                       torch.zeros(gx * gy, 256, 2)], dim=-1)
    ref = pallas_rgb_train.rgb_grads_pallas(
        c["entry_geom"], jnp.asarray(c["start"]), jnp.asarray(c["count"]),
        c["tile_ids"], jnp.asarray(jpack.numpy()), grid_x=gx, grid_y=gy,
        interpret=True)
    ref = np.asarray(ref)[:n, :9]
    s = int(c["start"][BWD_END_TILE])
    after = np.zeros(n, bool)
    after[s + BWD_END_AT:s + int(c["count"][BWD_END_TILE])] = True
    scale = float(np.abs(ref).max())
    _scaled_close(out[~after], ref[~after], 1e-5)
    assert float(np.abs(ref[after]).max()) <= 1e-4 * scale
    assert not _zero_rows(out, c).any()
