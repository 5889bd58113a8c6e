"""K2's bf16 cell math (`bf16_cells`, fast16 and fused-query modes) against
the JAX package: the Pallas kernel with bf16_cells=True in interpret mode,
the gates of `TestFastPathEndToEnd` (test_quick_fast16_close_to_parity's
4e-2, test_fused_query_matches_unfused's 3e-2) and of
tests/test_serve.py::test_approx_serving_modes (mean 2e-2, max 2e-1).

The port's bf16 cells keep the transmittance as the Pallas kernel keeps
it, an f32 sum of bf16-rounded log1p(-alpha) with one bf16 exp, and round
at the same points.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.ops import pallas_blend
from langsplatv2_tpu.ops.rasterize import RasterizeSettings as JaxSettings
from langsplatv2_tpu.ops.rasterize import rasterize as jax_rasterize
from langsplatv2_tpu_torch.ops import blend, projection
from langsplatv2_tpu_torch.ops.rasterize import (RasterizeSettings,
                                                 rasterize,
                                                 rasterize_quick_query,
                                                 sorted_binning)

from test_torch_port_serve import _jax, _port, _req, ring  # noqa: F401
from torch_port_fixtures import camera, quick_pairs, scene

N, H, W = 800, 80, 112
L, K = 3, 64


@pytest.fixture(scope="module")
def case():
    """test_quick_fast16_close_to_parity's scene (seed 2)."""
    sc = scene(N, seed=2)
    qw, qi = quick_pairs(N, seed=2)
    view, pm, tfx, tfy = camera(H, W)
    return sc, qw, qi, view, pm, tfx, tfy


def _t(a):
    return torch.from_numpy(np.array(a))


def test_blend_cells_match_pallas_kernel(case):
    """fast16 K2 with bf16 cells (plain version) against the Pallas kernel
    with bf16_cells=True on the same segments and rows: atol 5e-4 (the
    sums' order, and the Pallas kernel's second rounding where a segment
    crosses its 256-entry chunks), below the cells' own effect: every
    output must differ from the f32 cells' by more than that."""
    sc, qw, qi, view, pm, tfx, tfy = case
    s = RasterizeSettings(H, W, tfx, tfy, 0, max_entries=2 ** 13)
    op = _t(sc["opacities"][:, 0])
    proj = projection.preprocess(
        _t(sc["means"]), _t(sc["scales"]), _t(sc["rotations"]), None,
        _t(sc["colors"]), _t(view), _t(pm), torch.zeros(3), tfx, tfy, W, H,
        0, opacities=op)
    g, start, count, _, _ = sorted_binning(s, proj, op)
    rows = blend.pack_fast16_rows(proj.xy, proj.conic, op, proj.rgb, _t(qw),
                                  _t(qi).int())
    bg = torch.tensor([0.2, 0.1, 0.4])
    args = (g, start, count, rows, bg, s.grid_x, s.grid_y, 12, 192, False)
    cells = blend.blend_tiles_fast16(*args, cells_bf16=True)
    f32 = blend.blend_tiles_fast16(*args)
    jrows = pallas_blend.pack_fast16_rows(
        *(jnp.asarray(x.numpy()) for x in (proj.xy, proj.conic, op,
                                           proj.rgb)),
        jnp.asarray(qw), jnp.asarray(qi))
    eg = pallas_blend.to_field_major(jrows[jnp.asarray(g.numpy())], 256)
    ref = pallas_blend.blend_tiles_pallas(
        eg, jnp.zeros((1, eg.shape[1]), jnp.float32),
        jnp.asarray(start.numpy()), jnp.asarray(count.numpy()),
        jnp.arange(s.grid_x * s.grid_y, dtype=jnp.int32),
        jnp.asarray(bg.numpy()), grid_x=s.grid_x, grid_y=s.grid_y,
        mode="quick", out_channels=192, topk=12, chunk=256, rowfmt="fast16",
        banded=True, bf16_cells=True, interpret=True)
    for a, b, c in zip(cells, ref, f32):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4)
        assert float((a - c).abs().max()) > 5e-4
    # The query mode runs the same cells: its map is the fast16 one.
    phi = torch.zeros(L, K, 1)
    rgb_q, _, _, t_q = blend.blend_tiles_query(
        g, start, count, rows, bg, s.grid_x, s.grid_y, 12, phi,
        torch.zeros(L, K, K), cells_bf16=True)
    assert torch.equal(rgb_q, cells[0]) and torch.equal(t_q, cells[2])


def test_quick_fast16_close_to_parity(case):
    """The port's bf16-cell frame against JAX's parity (f32) frame,
    atol 4e-2, as JAX holds its own bf16 cells."""
    sc, qw, qi, view, pm, tfx, tfy = case
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    z = np.zeros(3, np.float32)
    kw = dict(scales=sc["scales"], rotations=sc["rotations"],
              colors_precomp=sc["colors"], quick_weights=qw,
              quick_indices=qi, quick_channels=L * K)
    fields = dict(image_height=H, image_width=W, tanfovx=tfx, tanfovy=tfy,
                  sh_degree=0, max_entries=2 ** 13)
    ref = jax_rasterize(
        JaxSettings(**fields, tile_cap=512, tile_batch=4, impl="pallas"),
        jnp.asarray(sc["means"]), jnp.asarray(sc["opacities"]),
        jnp.asarray(view), jnp.asarray(pm), jnp.asarray(z), jnp.asarray(bg),
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()})
    cells = rasterize(RasterizeSettings(**fields, precision="bf16",
                                        bf16_cells=True),
                      sc["means"], sc["opacities"], view, pm, z, bg,
                      device="cpu", **kw)
    for a, b in ((cells.rgb, ref.rgb), (cells.feature_map, ref.feature_map),
                 (cells.final_transmittance, ref.final_transmittance)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   atol=4e-2)
    # bf16_cells is read only at precision="bf16", as in JAX.
    f32 = rasterize(RasterizeSettings(**fields, bf16_cells=True), sc["means"],
                    sc["opacities"], view, pm, z, bg, device="cpu", **kw)
    np.testing.assert_allclose(f32.feature_map.numpy(),
                               np.asarray(ref.feature_map), atol=3e-5)


def test_fused_query_matches_unfused(case):
    """rasterize_quick_query with bf16 cells against the query of the
    unfused f32-cell map (f32 tiles): raw and nrm2 within 3e-2 of their
    largest, JAX's gate for its own bf16 cells."""
    sc, qw, qi, view, pm, tfx, tfy = case
    rng = np.random.default_rng(3)
    cb = rng.normal(size=(L, K, 64)).astype(np.float32)
    phrases = rng.normal(size=(5, 64)).astype(np.float32)
    phi = _t(np.einsum("lkd,pd->lkp", cb, phrases))
    gram = _t(np.einsum("lkd,lmd->lkm", cb, cb))
    z = np.zeros(3, np.float32)
    kw = dict(scales=sc["scales"], rotations=sc["rotations"],
              colors_precomp=sc["colors"], quick_weights=qw,
              quick_indices=qi, quick_channels=L * K)
    s = RasterizeSettings(H, W, tfx, tfy, 0, max_entries=2 ** 13,
                          precision="bf16", assemble=False, feat_bf16=False)
    un = rasterize(s, sc["means"], sc["opacities"], view, pm, z, z,
                   device="cpu", **kw)
    wm = un.feature_map.reshape(-1, L, K)
    raw_ref = torch.einsum("qlk,lkp->qlp", wm, phi)
    nrm2_ref = torch.einsum("qlk,lkm,qlm->ql", wm, gram, wm)
    out = rasterize_quick_query(s._replace(bf16_cells=True), sc["means"],
                                sc["opacities"], view, pm, z, z, phi=phi,
                                gram=gram, device="cpu", **kw)
    for a, b in ((out[1].reshape(-1, L, 5), raw_ref),
                 (out[2].reshape(-1, L), nrm2_ref)):
        err = float((a - b).abs().max() / b.abs().max())
        assert err <= 3e-2, err
    plain = rasterize_quick_query(s, sc["means"], sc["opacities"], view, pm,
                                  z, z, phi=phi, gram=gram, device="cpu",
                                  **kw)
    assert not torch.equal(plain[1], out[1])


def test_approx_serving_modes(ring):
    """BackendRenderer(bf16_cells=True, tile_budget=1e-6) on
    tests/test_serve.py's ring: against the exact server (the JAX gate:
    mean 2e-2, max 2e-1) and against JAX's approximate server (the
    same), fresh and through temporal steady frames."""
    fast = dict(bf16_cells=True, tile_budget=1e-6, tile_budget_cap=128)
    ref = _port(ring).render_request(_req())
    port = _port(ring, **fast)
    out = port.render_request(_req())
    assert port.bf16_cells and out.shape == ref.shape
    assert np.isfinite(out).all()
    d = np.abs(ref - out)
    assert d.mean() < 2e-2 and d.max() < 2e-1, (d.mean(), d.max())
    jx = _jax(ring, **fast).render_request(_req())
    d = np.abs(jx - out)
    assert d.mean() < 2e-2 and d.max() < 2e-1, (d.mean(), d.max())
    temporal = dict(fast, temporal_reuse_px=8.0, reuse_zref=2.0)
    port_t, jax_t = _port(ring, **temporal), _jax(ring, **temporal)
    for r in (_req(0.0), _req(0.005)):
        a, b = port_t.render_request(r), jax_t.render_request(r)
        d = np.abs(a - b)
        assert d.mean() < 2e-2 and d.max() < 2e-1, (d.mean(), d.max())
    assert port_t.cache_hits["steady"] == 1 == jax_t.cache_hits["steady"]
    q = port_t._pose_entry["wm16"]
    assert q.dtype == torch.bfloat16 and bool(torch.isfinite(
        q.float()).all())
