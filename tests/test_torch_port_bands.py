"""The level-band rule of the fast16 and fused-query blends (ROADMAP
Queue 3, F1): slot j of level l = j // (topk / L) is added only when its
index lies in [64 l, 64 l + 64), as JAX's `_blend_kernel(banded=True)`
does, here in interpret mode on the CPU.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.ops import pallas_blend
from langsplatv2_tpu.ops.rasterize import RasterizeSettings as JaxSettings
from langsplatv2_tpu.ops.rasterize import rasterize as jax_rasterize
from langsplatv2_tpu_torch.ops import blend
from langsplatv2_tpu_torch.ops.query import round_bf16
from langsplatv2_tpu_torch.ops.rasterize import (RasterizeSettings,
                                                 rasterize,
                                                 rasterize_quick_query)

from torch_port_fixtures import camera, quick_pairs, scene

CENTRE = 8 * 16 + 8   # pixel (8, 8) of the tile


def _smallest_input():
    """ROADMAP's smallest input: one 16x16 tile, one Gaussian at (8, 8),
    conic (0.05, 0, 0.05), opacity 0.5, 12 pairs; slot 0 (level 0) has
    index 100 and weight 0.7, slots 1-11 lie in their bands."""
    qi = np.array([100] + [64 * (j // 4) + j for j in range(1, 12)],
                  np.float32)[None]
    qw = np.array([0.7] + [0.3 / 11] * 11, np.float32)[None]
    return dict(xy=np.array([[8.0, 8.0]], np.float32),
                conic=np.array([[0.05, 0.0, 0.05]], np.float32),
                op=np.array([0.5], np.float32),
                rgb=np.array([[0.2, 0.4, 0.6]], np.float32), qw=qw, qi=qi)


def _jax_rows(x):
    rows = pallas_blend.pack_fast16_rows(
        jnp.asarray(x["xy"]), jnp.asarray(x["conic"]), jnp.asarray(x["op"]),
        jnp.asarray(x["rgb"]), jnp.asarray(x["qw"]), jnp.asarray(x["qi"]))
    one = jnp.zeros((1,), jnp.int32)
    return (pallas_blend.to_field_major(rows, 256), one, one + 1, one,
            jnp.zeros(3, jnp.float32))


def _port_rows(x):
    T = torch.from_numpy
    rows = blend.pack_fast16_rows(T(x["xy"]), T(x["conic"]), T(x["op"]),
                                  T(x["rgb"]), T(x["qw"]),
                                  T(x["qi"]).int())
    one = torch.zeros(1, dtype=torch.int32)
    return one, one, one + 1, rows, torch.zeros(3)


def test_fast16_blend_drops_out_of_band_pairs():
    x = _smallest_input()
    geom, ts, tc, tid, bg = _jax_rows(x)
    _, ref, _ = pallas_blend.blend_tiles_pallas(
        geom, jnp.zeros((1, geom.shape[1]), jnp.float32), ts, tc, tid, bg,
        grid_x=1, grid_y=1, mode="quick", out_channels=192, topk=12,
        chunk=256, rowfmt="fast16", banded=True, interpret=True)
    ref = np.asarray(ref)
    g, s, c, rows, bgp = _port_rows(x)
    _, feat, _ = blend.blend_tiles_fast16(g, s, c, rows, bgp, 1, 1, 12, 192,
                                          False)
    assert float(ref[0, CENTRE, 100]) == 0.0
    assert float(feat[0, CENTRE, 100]) == 0.0
    np.testing.assert_allclose(feat.numpy(), ref, atol=1e-6)
    # Without the rule (JAX's unbanded kernel) the pair lands in channel
    # 100 (the fault).
    _, unbanded, _ = blend.blend_tiles_fast16(g, s, c, rows, bgp, 1, 1, 12,
                                              192, False, banded=False)
    assert abs(float(unbanded[0, CENTRE, 100]) - 0.5 * 0.69921875) < 1e-6


def test_fused_query_drops_out_of_band_pairs():
    x = _smallest_input()
    rng = np.random.default_rng(1)
    phi = round_bf16(torch.from_numpy(
        rng.normal(size=(3, 64, 2)).astype(np.float32)))
    cb = rng.normal(size=(3, 64, 8)).astype(np.float32)
    gram = round_bf16(torch.from_numpy(np.einsum("lkd,lmd->lkm", cb, cb)))
    geom, ts, tc, tid, bg = _jax_rows(x)
    _, raw_j, nrm2_j, _ = pallas_blend.blend_tiles_query(
        geom, ts, tc, tid, bg, jnp.asarray(phi.numpy()),
        jnp.asarray(gram.numpy()), grid_x=1, grid_y=1, out_channels=192,
        topk=12, banded=True, interpret=True)
    g, s, c, rows, bgp = _port_rows(x)
    _, raw, nrm2, _ = blend.blend_tiles_query(g, s, c, rows, bgp, 1, 1, 12,
                                              phi, gram)
    # The port's products take the weights rounded to bf16 (the TPU's MXU
    # pass), JAX's interpret mode f32 ones: 5e-3 of the largest, as
    # test_fused_query_matches_unfused holds them; at the centre pixel the
    # weights are bf16 values and the two agree closely.
    for a, b in ((raw, raw_j), (nrm2, nrm2_j)):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=5e-3)
        np.testing.assert_allclose(a[0, CENTRE].numpy(), b[0, CENTRE],
                                   rtol=1e-5, atol=1e-7)
    # The scores are those of the banded map, channel 100 at 0.
    _, wm, _ = blend.blend_tiles_fast16(g, s, c, rows, bgp, 1, 1, 12, 192,
                                        False)
    want = torch.einsum("lk,lkq->lq", round_bf16(wm[0, CENTRE].reshape(3, 64)),
                        phi)
    torch.testing.assert_close(raw[0, CENTRE], want.reshape(-1), rtol=1e-5,
                               atol=1e-6)


def test_merged_model_frame_is_unchanged_by_bands():
    """Merged quick models keep each level's indices in its band, so the
    rule changes no output there."""
    sc = scene(300, seed=4)
    qw, qi = quick_pairs(300, topk=4, seed=5)
    view, pm, tfx, tfy = camera(48, 64)
    s = RasterizeSettings(48, 64, tfx, tfy, 0, max_entries=2 ** 13,
                          precision="bf16", feat_bf16=False, assemble=False)
    from langsplatv2_tpu_torch.ops.rasterize import fast16_binned
    b = fast16_binned(s, sc["means"], sc["opacities"], view, pm,
                      np.zeros(3, np.float32), sc["scales"],
                      sc["rotations"], colors_precomp=sc["colors"],
                      quick_weights=qw, quick_indices=qi, dev="cpu")
    args = (b.g, b.start, b.count, b.rows, torch.zeros(3), s.grid_x,
            s.grid_y, 12, 192, False)
    for a, c in zip(blend.blend_tiles_fast16(*args),
                    blend.blend_tiles_fast16(*args, banded=False)):
        assert torch.equal(a, c)


@pytest.mark.parametrize("fused", [False, True], ids=["fast16", "fused"])
def test_crossing_indices_frame_matches_jax(fused):
    """A quick model whose indices cross the level bands: the port's
    fast16 frame (and fused query) apply JAX's rule end to end."""
    n, h, w = 300, 48, 64
    sc = scene(n, seed=6)
    rng = np.random.default_rng(6)
    qw = rng.uniform(0, 1, (n, 12)).astype(np.float32)
    qw /= qw.sum(1, keepdims=True)
    qi = np.stack([rng.choice(192, 12, replace=False) for _ in range(n)]
                  ).astype(np.float32)
    view, pm, tfx, tfy = camera(h, w)
    kw = dict(scales=sc["scales"], rotations=sc["rotations"],
              colors_precomp=sc["colors"], quick_weights=qw,
              quick_indices=qi)
    fields = dict(image_height=h, image_width=w, tanfovx=tfx, tanfovy=tfy,
                  sh_degree=0, max_entries=2 ** 13, precision="bf16",
                  feat_bf16=False, assemble=False)
    z = np.zeros(3, np.float32)
    if not fused:
        ref = jax_rasterize(
            JaxSettings(**fields, impl="pallas"), jnp.asarray(sc["means"]),
            jnp.asarray(sc["opacities"]), jnp.asarray(view), jnp.asarray(pm),
            jnp.asarray(z), jnp.asarray(z),
            **{k: jnp.asarray(v) for k, v in kw.items()},
            quick_channels=192)
        out = rasterize(RasterizeSettings(**fields), sc["means"],
                        sc["opacities"], view, pm, z, z, quick_channels=192,
                        device="cpu", **kw)
        # fast16 numerics differ at ~1e-3; an out-of-band pair would
        # differ by its whole weight.
        np.testing.assert_allclose(out.feature_map.numpy(),
                                   np.asarray(ref.feature_map), atol=2e-2)
        return
    from langsplatv2_tpu.ops.rasterize import \
        rasterize_quick_query as jax_query
    phi = round_bf16(torch.from_numpy(
        rng.normal(size=(3, 64, 2)).astype(np.float32)))
    gram = torch.eye(64).repeat(3, 1, 1)
    ref = jax_query(JaxSettings(**fields, impl="pallas"),
                    jnp.asarray(sc["means"]), jnp.asarray(sc["opacities"]),
                    jnp.asarray(view), jnp.asarray(pm), jnp.asarray(z),
                    jnp.asarray(z),
                    **{k: jnp.asarray(v) for k, v in kw.items()},
                    phi=jnp.asarray(phi.numpy()),
                    gram=jnp.asarray(gram.numpy()), quick_channels=192)
    out = rasterize_quick_query(RasterizeSettings(**fields), sc["means"],
                                sc["opacities"], view, pm, z, z, phi=phi,
                                gram=gram, device="cpu", **kw)
    for a, b in ((out[1], ref[1]), (out[2], ref[2])):
        scale = float(np.abs(np.asarray(b)).max())
        np.testing.assert_allclose(a.numpy() / scale, np.asarray(b) / scale,
                                   atol=2e-2)
