"""The port's fused-query serving frame (`rasterize_quick_query`, K2's query
mode) and its render server (`serve/backend.py`) against the JAX package.

JAX side as its own tests run it on the CPU (impl="pallas", Pallas kernels
in interpret mode); port side on device="cpu", so every kernel wrapper runs
its plain version. Scenes: the 800-splat 80x112 scene of
tests/test_torch_port_capped.py, and tests/test_serve.py's 40-splat ring
for the server.
"""
import math
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.eval.openclip import OpenCLIPNetwork as JaxCLIP
from langsplatv2_tpu.models import gaussians as jax_gm
from langsplatv2_tpu.ops.rasterize import RasterizeSettings as JaxSettings
from langsplatv2_tpu.ops.rasterize import \
    rasterize_quick_query as jax_quick_query
from langsplatv2_tpu.serve.backend import BackendRenderer as JaxBackend
from langsplatv2_tpu_torch.eval.openclip import OpenCLIPNetwork
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.ops import query
from langsplatv2_tpu_torch.ops.rasterize import (RasterizeSettings, rasterize,
                                                 rasterize_quick_query)
from langsplatv2_tpu_torch.serve.backend import BackendRenderer

from torch_port_fixtures import camera, scene, within_one_bf16_ulp

H, W = 80, 112
L, K, TOPK, PQ = 3, 64, 4, 5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def quick_case():
    """tests/test_torch_port_capped.py's seed-4 scene (TestBudgetCapped-
    Binning._quick_scene) and prompt constants as the hash backend makes
    them: 512-d codebooks, 1 positive and 4 negatives."""
    sc = scene(800, seed=4)
    rng = np.random.default_rng(4)
    qw = rng.uniform(0, 1, (800, L * TOPK)).astype(np.float32)
    qw /= qw.sum(1, keepdims=True)
    qi = np.concatenate([rng.integers(0, K, (800, TOPK)) + lvl * K
                         for lvl in range(L)], 1).astype(np.float32)
    clip = OpenCLIPNetwork("hash", device="cpu")
    clip.set_positives(["red car"])
    books = np.random.default_rng(9).normal(size=(L, K, 512))
    phi, gram = clip.prompt_constants(_t(books.astype(np.float32)))
    return sc, qw, qi, phi, gram


def _query_args(sc, qw, qi):
    view, pm, tfx, tfy = camera(H, W)
    return (view, pm, np.zeros(3, np.float32), np.zeros(3, np.float32)), \
        dict(scales=sc["scales"], rotations=sc["rotations"],
             colors_precomp=sc["colors"], quick_weights=qw,
             quick_indices=qi), tfx, tfy


ROUTES = {"exact": {}, "live-clamped": dict(live_entries=2048),
          "capped": dict(tile_budget=1e-6, tile_budget_cap=128)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_rasterize_quick_query_matches_jax(quick_case, route):
    """Against JAX's rasterize_quick_query given the same bf16-rounded phi
    and gram (what its TPU MXU pass reads): raw and nrm2 within 5e-3 of
    their largest (on the CPU JAX multiplies the f32 weights, the port their
    bf16 rounding as the TPU does), rgb and final T within 1e-4 (no output
    rounding), entry totals equal."""
    sc, qw, qi, phi, gram = quick_case
    phi, gram = query.round_bf16(phi), query.round_bf16(gram)
    (view, pm, campos, bg), kw, tfx, tfy = _query_args(sc, qw, qi)
    change = ROUTES[route]
    js = JaxSettings(image_height=H, image_width=W, tanfovx=tfx, tanfovy=tfy,
                     sh_degree=0, max_entries=2 ** 13, tile_cap=512,
                     tile_batch=4, impl="pallas", binning="sort",
                     precision="bf16", assemble=False)._replace(**change)
    ref = jax_quick_query(
        js, jnp.asarray(sc["means"]), jnp.asarray(sc["opacities"]),
        *(jnp.asarray(x) for x in (view, pm, campos, bg)),
        **{k: jnp.asarray(v) for k, v in kw.items()},
        phi=jnp.asarray(phi.numpy()), gram=jnp.asarray(gram.numpy()),
        quick_channels=L * K)
    ps = RasterizeSettings(H, W, tfx, tfy, 0, max_entries=2 ** 13,
                           tile_cap=512, precision="bf16")._replace(**change)
    out = rasterize_quick_query(ps, sc["means"], sc["opacities"], view, pm,
                                campos, bg, **kw, phi=phi, gram=gram,
                                quick_channels=L * K, device="cpu")
    assert out[1].shape == (ps.grid_x * ps.grid_y, 256, L * PQ)
    assert out[2].shape == (ps.grid_x * ps.grid_y, 256, L)
    for i in (5, 6):                   # total_entries, live_total
        assert int(out[i]) == int(ref[i]), i
    if route == "live-clamped":
        assert int(out[6]) > ps.live_entries         # the clamp cuts
    for i in (1, 2):
        b = np.asarray(ref[i])
        err = float(np.abs(out[i].numpy() - b).max() / np.abs(b).max())
        assert err <= 5e-3, (i, err)
    for i in (0, 3):
        err = float(np.abs(out[i].numpy() - np.asarray(ref[i])).max())
        assert err <= 1e-4, (i, err)
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))


@pytest.mark.parametrize("route", ["exact", "capped"])
def test_fused_query_matches_the_unfused_route(quick_case, route):
    """The fused frame against the port's own unfused route on the same
    frame: against f32 tiles (feat_bf16 off) through f32 K3, 5e-3 of the
    largest (JAX's test_fused_query_matches_unfused envelope: the fused
    products take bf16 operands); against the bf16 tiles through bf16 K3,
    raw to the order of the sums (1e-6 of the largest: the same bf16
    products) and nrm2 within 5e-3 (its last factor is the f32 weight)."""
    sc, qw, qi, phi, gram = quick_case
    (view, pm, campos, bg), kw, tfx, tfy = _query_args(sc, qw, qi)
    ps = RasterizeSettings(H, W, tfx, tfy, 0, max_entries=2 ** 13,
                           tile_cap=512, precision="bf16",
                           assemble=False)._replace(**ROUTES[route])
    args = (sc["means"], sc["opacities"], view, pm, campos, bg)
    out = rasterize_quick_query(ps, *args, **kw, phi=phi, gram=gram,
                                quick_channels=L * K, device="cpu")
    for feat_bf16, raw_tol in ((False, 5e-3), (True, 1e-6)):
        un = rasterize(ps._replace(feat_bf16=feat_bf16), *args, **kw,
                       quick_channels=L * K, device="cpu")
        raw, nrm2 = query.query_map_tiles(un.feature_map, phi, gram)
        for a, b, tol in ((out[1], raw, raw_tol), (out[2], nrm2, 5e-3)):
            err = float((a - b).abs().max() / b.abs().max())
            assert err <= tol, (feat_bf16, err)
        if not feat_bf16:
            torch.testing.assert_close(out[0], un.rgb, atol=1e-6, rtol=0)
        assert int(out[6]) == int(un.live_total)


# ------------------------------------------------------------ the server

@pytest.fixture(scope="module")
def ring():
    """tests/test_serve.py's merged model (40 splats on a ring at z = 5),
    as JAX builds it and as the port reads its fields."""
    n = 40
    rng = np.random.default_rng(0)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([np.cos(ang), np.sin(ang), np.full(n, 5.0)],
                   1).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    jm = jax_gm.create_from_pcd(pts, cols, 1.0, capacity=n)
    qw = rng.uniform(0, 1, (n, L * 4)).astype(np.float32)
    qw /= qw.sum(1, keepdims=True)
    qi = np.concatenate([rng.integers(0, K, (n, 4)) + lvl * K
                         for lvl in range(L)], 1).astype(np.float32)
    jm = jm.replace(
        quick_weights=jnp.asarray(qw), quick_indices=jnp.asarray(qi),
        codebooks=jnp.asarray(rng.normal(size=(L, K, 512)).astype(
            np.float32)))
    fields = {k: np.asarray(getattr(jm, k)) for k in (
        "xyz", "features_dc", "features_rest", "scaling", "rotation",
        "opacity", "live", "codebooks", "quick_weights", "quick_indices")}
    pm = from_numpy_params(fields, active_sh_degree=jm.active_sh_degree,
                           device="cpu")
    return jm, pm


KW = dict(max_entries=2 ** 12, tile_cap=256)


def _req(dx=0.0, prompt="red car", heatmap=True, thresh=-10.0):
    c2w = np.eye(4)
    c2w[0, 3] = dx
    return {"c2w": c2w.tolist(), "width": 96, "height": 64,
            "fov_y": math.radians(60), "prompt": prompt,
            "show_heatmap": heatmap, "threshold": thresh}


def _port(ring, **kw):
    return BackendRenderer(ring[1], clip_model=OpenCLIPNetwork(
        "hash", device="cpu"), device="cpu", **KW, **kw)


def _jax(ring, **kw):
    return JaxBackend(ring[0], clip_model=JaxCLIP(backend="hash"), **KW, **kw)


@pytest.mark.parametrize("heatmap", [False, True])
def test_request_matches_jax(ring, heatmap):
    """An rgb request and a heatmap request (host compose: cv2 JET) against
    JAX's images: heatmaps within 2e-2 (a few cv2 table steps: the fast16
    blends differ by a bf16 ulp, which can move a similarity across one of
    the 256 steps), rgb requests (f32 rows in both) within 1e-5."""
    req = _req(heatmap=heatmap)
    ref = _jax(ring).render_request(req)
    out = _port(ring).render_request(req)
    assert out.shape == ref.shape == (64, 96, 3)
    d = np.abs(out - ref)
    assert d.max() < (2e-2 if heatmap else 1e-5), d.max()


def test_query_compose_matches_jax(ring):
    """_query_compose on the same bf16 map, rgb and prompt constants (the
    cross-level [L, L, K, K] Gram of _phi_gram): similarity at 1e-5; the
    device composite within one u8 level."""
    rng = np.random.default_rng(3)
    h, w = 24, 40
    wm = rng.uniform(0, 0.3, (L * K, h, w)).astype(np.float32)
    wm16 = jnp.asarray(wm).astype(jnp.bfloat16)
    rgb = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    cb = np.asarray(ring[0].codebooks)
    text = rng.normal(size=512).astype(np.float32)
    text /= np.linalg.norm(text)
    phi = np.einsum("lkd,d->lk", cb, text).astype(np.float32)
    gram = np.einsum("lkd,jmd->ljkm", cb, cb).astype(np.float32)
    for dev in (False, True):
        ref = JaxBackend._query_compose(
            jnp.asarray(rgb), wm16, jnp.asarray(phi), jnp.asarray(gram),
            jnp.float32(-10.0), L, K, dev)
        out = BackendRenderer._query_compose(
            _t(rgb), _t(wm).to(torch.bfloat16), _t(phi), _t(gram), -10.0,
            L, K, dev)
        if dev:
            d = np.abs(out[0].numpy().astype(int)
                       - np.asarray(ref[0]).astype(int))
            assert out[0].dtype == torch.uint8 and d.max() <= 1
        else:
            np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                                       atol=1e-5)


def test_device_compose_matches_host(ring):
    """test_device_compose_matches_host on the port: the analytic JET on
    the card against cv2's on the host within the colormap's table
    quantization; rgb requests are unaffected by the compose mode."""
    host = _port(ring).render_request(_req())
    dev = _port(ring, compose="device").render_request(_req())
    d = np.abs(host - dev)
    assert dev.shape == host.shape
    assert d.mean() < 2e-2 and d.max() < 0.13, (d.mean(), d.max())
    a = _port(ring).render_request(_req(heatmap=False))
    b = _port(ring, compose="device").render_request(_req(heatmap=False))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_pose_cache_and_dispatch_finalize_split(ring):
    """A pose-cache hit (same pose, new prompt or threshold) equals a fresh
    server's miss; a pose change re-renders; the cache off gives the same
    images; dispatched frames finalize to the images of render_request."""
    cached = _port(ring)
    img0 = cached.render_request(_req(prompt="red car"))
    hit1 = cached.render_request(_req(prompt="blue box"))
    hit2 = cached.render_request(_req(prompt="blue box", thresh=0.5))
    assert cached.cache_hits["pose"] == 2 and cached.cache_hits["miss"] == 1
    np.testing.assert_allclose(
        hit1, _port(ring).render_request(_req(prompt="blue box")), atol=1e-6)
    np.testing.assert_allclose(
        hit2, _port(ring).render_request(_req(prompt="blue box", thresh=0.5)),
        atol=1e-6)
    np.testing.assert_allclose(cached.render_request(_req(prompt="red car")),
                               img0, atol=1e-6)
    moved = cached.render_request(_req(dx=0.3, prompt="blue box"))
    assert cached.cache_hits["miss"] == 2
    np.testing.assert_allclose(
        moved, _port(ring).render_request(_req(dx=0.3, prompt="blue box")),
        atol=1e-6)
    off = _port(ring, pose_cache=False)
    np.testing.assert_allclose(off.render_request(_req(prompt="blue box")),
                               hit1, atol=1e-6)
    assert off.cache_hits["pose"] == 0

    backend = _port(ring)
    reqs = [_req(dx) for dx in (0.0, 0.1, 0.2)]
    piped = [backend.finalize_frame(p)
             for p in [backend.dispatch_request(r) for r in reqs]]
    for r, img in zip(reqs, piped):
        np.testing.assert_allclose(_port(ring).render_request(r), img,
                                   atol=1e-6)


def test_temporal_serving_matches_jax(ring):
    """The temporal server on one request sequence (bin, sub-threshold
    steps, a jump, a heatmap-off request): the rebin and steady counters
    equal JAX's after every request; each request's blend output (the
    pose entry: rgb and the bf16 map, before the query and compose) is
    within the fast16 envelope of JAX's (one bf16 ulp; 1e-4 on the
    colour), and the composited image within the heatmap's (mean 2e-2,
    max 0.2: the JET normalization stretches the similarity's range); the
    bin frame equals a capped server's frame without temporal reuse to
    1e-5."""
    kw = dict(tile_budget=1e-6, tile_budget_cap=128, temporal_reuse_px=8.0,
              reuse_zref=2.0)
    port, jx = _port(ring, **kw), _jax(ring, **kw)
    seq = [_req(0.0), _req(0.005), _req(0.01), _req(2.0), _req(2.003),
           _req(2.006, heatmap=False), _req(0.0)]
    for r in seq:
        a, b = port.render_request(r), jx.render_request(r)
        assert port.cache_hits == jx.cache_hits, (port.cache_hits,
                                                  jx.cache_hits)
        ep, ej = port._pose_entry, jx._pose_entry
        assert within_one_bf16_ulp(
            ep["rgb"], _t(np.asarray(ej["rgb"], np.float32)), 1e-4)
        if r["show_heatmap"]:
            assert ep["wm16"].dtype == torch.bfloat16
            assert within_one_bf16_ulp(
                ep["wm16"], _t(np.asarray(ej["wm16"], np.float32)), 1e-6)
        d = np.abs(a - b)
        assert d.mean() < 2e-2 and d.max() < 0.2, (d.mean(), d.max())
    assert port.cache_hits["steady"] == 3 and port.cache_hits["rebin"] == 4
    assert port.cache_hits["pose"] == 0
    full = _port(ring, tile_budget=1e-6, tile_budget_cap=128,
                 pose_cache=False)
    np.testing.assert_allclose(_port(ring, **kw).render_request(_req(0.0)),
                               full.render_request(_req(0.0)), atol=1e-5)


def test_server_option_errors(ring):
    with pytest.raises(ValueError, match="budget-capped"):
        _port(ring, temporal_reuse_px=4.0)
    assert _port(ring, bf16_cells=True).bf16_cells   # ported: accepted
    with pytest.raises(ValueError, match="compose"):
        _port(ring, compose="gpu")


def test_pipelined_zmq_loopback(ring):
    """run_pipelined (ROUTER) with the port's PipelinedClient (DEALER),
    depth 2: every request gets a decodable JPEG, in order."""
    pytest.importorskip("zmq")
    cv2 = pytest.importorskip("cv2")
    from langsplatv2_tpu_torch.serve.frontend import PipelinedClient

    port = 15593
    backend = _port(ring, compose="device", zmq_port=port)
    threading.Thread(target=backend.run_pipelined, kwargs={"depth": 2},
                     daemon=True).start()
    client = PipelinedClient(f"tcp://localhost:{port}", depth=2)
    replies = []
    for i in range(5):
        client.submit(_req(0.05 * i))
        r = client.collect()
        if r is not None:
            replies.append(r)
    replies.extend(client.drain())
    assert len(replies) == 5
    for r in replies:
        img = cv2.imdecode(np.frombuffer(r, np.uint8), cv2.IMREAD_COLOR)
        assert img is not None and img.shape == (64, 96, 3)
