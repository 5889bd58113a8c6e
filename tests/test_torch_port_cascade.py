"""K8, the cascade binner (`binning="cascade"`), against the JAX package's
`cascade_binning` in interpret mode and the port's own sort binning
(tests/test_pallas_kernels.py::TestCascadeBinning's scenes).

One call of JAX's cascade in interpret mode costs over a minute here (its
last level unrolls 64 partition appends whatever the grid), so this file
makes one, for the segments; the frames are held, as TestCascadeBinning
holds JAX's, against the XLA reference rasterizer.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.ops import pallas_cascade, projection as jax_projection
from langsplatv2_tpu.ops.rasterize import RasterizeSettings as JaxSettings
from langsplatv2_tpu.ops.rasterize import rasterize as jax_rasterize
from langsplatv2_tpu_torch.ops import cascade, expand
from langsplatv2_tpu_torch.ops.projection import ProjectedGaussians
from langsplatv2_tpu_torch.ops.rasterize import RasterizeSettings, rasterize

from torch_port_fixtures import camera, quick_pairs, scene


def _projected(n, h, w, seed):
    """JAX's preprocess of the scene, and the same fields as the port's
    ProjectedGaussians: both binnings read identical inputs."""
    sc = scene(n, seed)
    view, pm, tfx, tfy = camera(h, w)
    proj = jax_projection.preprocess(
        jnp.asarray(sc["means"]), jnp.asarray(sc["scales"]),
        jnp.asarray(sc["rotations"]), None, None, jnp.asarray(sc["colors"]),
        jnp.asarray(view), jnp.asarray(pm), jnp.zeros(3, jnp.float32), tfx,
        tfy, w, h, 0, 1.0)
    port = ProjectedGaussians(*(None if x is None else torch.from_numpy(
        np.array(x)) for x in proj))
    return sc, proj, port


def test_segments_match_jax_and_the_sort_binning():
    """Every tile's segment (count, and the depth-ordered Gaussians) equals
    JAX's cascade's (its rows' x and y) and the port's sort binning's
    (Gaussian ids), bit for bit, at 96x144 (a band boundary in y, two in
    x)."""
    n, gx, gy = 700, 9, 6
    sc, jproj, proj = _projected(n, 96, 144, seed=9)
    ops = sc["opacities"][:, 0]
    op = torch.from_numpy(ops)
    geom_rows, feat_rows = pallas_cascade.pack_cascade_rows(
        jproj, jnp.asarray(ops), None, None)
    entries, cts, ctc, tot, ovf = (np.asarray(a) for a in
                                   pallas_cascade.cascade_binning(
                                       geom_rows, feat_rows, jproj.depth,
                                       gx, gy, budget4=2 ** 13,
                                       interpret=True))
    g, start, count, total, overflow = cascade.cascade_binning(
        proj, op, gx, gy, 2 ** 13)
    assert not bool(ovf) and not bool(overflow)
    assert int(total) == int(tot) == int(count.sum())
    tile, depth, gauss, _ = expand.expand_entries(proj, op, gx, gy, 2 ** 13)
    g_s, start_s, count_s = expand.sort_entries(tile, depth, gauss, gx * gy)
    np.testing.assert_array_equal(count.numpy(), ctc)
    np.testing.assert_array_equal(count.numpy(), count_s.numpy())
    xy = proj.xy.numpy()
    for t in range(gx * gy):
        seg = g[start[t]:start[t] + count[t]].long()
        assert torch.equal(seg, g_s[start_s[t]:start_s[t] + count_s[t]].long())
        np.testing.assert_array_equal(xy[seg.numpy()].T,
                                      entries[:2, cts[t]:cts[t] + ctc[t]])
    assert int(count.max()) > 0 and int((count > 0).sum()) > gx * gy // 2


def test_budget_overflow_flag():
    """At budget 512 (below the live total) the flag is set and the kept
    total stays within the budget (JAX flags this input too,
    TestCascadeBinning::test_budget_overflow_flag); what is kept is the
    first tiles' full segments, in row-major order."""
    sc, _, proj = _projected(700, 96, 144, seed=9)
    op = torch.from_numpy(sc["opacities"][:, 0])
    g, start, count, total, overflow = cascade.cascade_binning(
        proj, op, 9, 6, 512)
    assert bool(overflow)
    assert 0 < int(total) <= 512 and int(count.sum()) == int(total)
    full, _, count_full, total_full, overflow_full = \
        cascade.cascade_binning(proj, op, 9, 6, 2 ** 13)
    assert not bool(overflow_full) and int(total_full) > 512
    kept = count > 0
    assert torch.equal(count[kept], count_full[kept])
    assert torch.equal(g[:int(total)], full[:int(total)])
    assert not bool(kept[int(kept.nonzero().max()) + 1:].any())


@pytest.mark.parametrize("hw,seed", [((80, 112), 2), ((160, 288), 5)])
def test_quick_matches_xla_multiband(hw, seed):
    """The cascade quick frame (160x288: 10 tile rows of 18 tiles) against
    JAX's XLA reference frame, atol 3e-5 (JAX's gate for its own cascade
    frame), and equal to the port's sort-binned f32 frame, whose live
    total is the cascade's total_entries."""
    h, w = hw
    n = 900
    sc = scene(n, seed)
    qw, qi = quick_pairs(n, seed=7)
    view, pm, tfx, tfy = camera(h, w)
    bg = np.array([0.3, 0.2, 0.1], np.float32)
    z = np.zeros(3, np.float32)
    kw = dict(scales=sc["scales"], rotations=sc["rotations"],
              colors_precomp=sc["colors"], quick_weights=qw,
              quick_indices=qi, quick_channels=192)
    fields = dict(image_height=h, image_width=w, tanfovx=tfx, tanfovy=tfy,
                  sh_degree=0, max_entries=2 ** 17, tile_cap=2048)
    ref = jax_rasterize(
        JaxSettings(**fields, tile_batch=4, impl="xla"),
        jnp.asarray(sc["means"]), jnp.asarray(sc["opacities"]),
        jnp.asarray(view), jnp.asarray(pm), jnp.asarray(z), jnp.asarray(bg),
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    s = RasterizeSettings(**fields, binning="cascade")
    out = rasterize(s, sc["means"], sc["opacities"], view, pm, z, bg,
                    device="cpu", **kw)
    for a, b in ((out.rgb, ref.rgb), (out.feature_map, ref.feature_map),
                 (out.final_transmittance, ref.final_transmittance)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5)
    assert out.live_total is None
    sort = rasterize(s._replace(binning="sort"), sc["means"],
                     sc["opacities"], view, pm, z, bg, device="cpu", **kw)
    for a, b in ((out.rgb, sort.rgb), (out.feature_map, sort.feature_map),
                 (out.final_transmittance, sort.final_transmittance)):
        assert torch.equal(a, b)
    assert int(out.total_entries) == int(sort.live_total)


def test_rgb_frame_routes():
    """An RGB frame takes the cascade under impl="pallas" (equal to the
    sort frame); under "auto" it takes the XLA route, as JAX's does
    (binned by bin_gaussians, not the cascade): JAX's impl="auto" frame
    and telemetry, images atol 1e-5."""
    n, h, w = 300, 48, 64
    sc = scene(n, 3)
    view, pm, tfx, tfy = camera(h, w)
    z = np.zeros(3, np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    kw = dict(scales=sc["scales"], rotations=sc["rotations"],
              colors_precomp=sc["colors"], device="cpu")
    s = RasterizeSettings(h, w, tfx, tfy, 0, max_entries=2 ** 12,
                          binning="cascade")
    auto = rasterize(s, sc["means"], sc["opacities"], view, pm, z, bg, **kw)
    jkw = {k: jnp.asarray(sc[k]) for k in ("scales", "rotations")}
    ref = jax.jit(lambda m, o: jax_rasterize(
        JaxSettings(image_height=h, image_width=w, tanfovx=tfx, tanfovy=tfy,
                    sh_degree=0, max_entries=2 ** 12, binning="cascade"),
        m, o, view, pm, z, bg, colors_precomp=jnp.asarray(sc["colors"]),
        **jkw))(jnp.asarray(sc["means"]), jnp.asarray(sc["opacities"]))
    for a, b in ((auto.rgb, ref.rgb),
                 (auto.final_transmittance, ref.final_transmittance)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    assert (int(auto.max_tile_count), int(auto.total_entries)) == \
        (int(ref.max_tile_count), int(ref.total_entries))
    out = rasterize(s._replace(impl="pallas"), sc["means"], sc["opacities"],
                    view, pm, z, bg, **kw)
    ref = rasterize(s._replace(binning="sort"), sc["means"],
                    sc["opacities"], view, pm, z, bg, **kw)
    assert torch.equal(out.rgb, ref.rgb.detach())
    assert out.feature_map is None and not out.rgb.requires_grad
    assert math.isfinite(float(out.rgb.sum()))
