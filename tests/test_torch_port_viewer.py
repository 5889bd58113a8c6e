"""The viewer and the render server's command line, port against the JAX
package, on the CPU:

- the SIBR bridge (`serve/network_gui.py`): tests/test_network_gui.py's
  loopback run against both packages' bridges gives the same bytes; the
  negated columns, a zero-resolution request whose flags still count, and
  a dropped connection that resets `conn`;
- `MiniCam` (centre, tangents) and `GaussianModel.get_covariance`;
- `render` with `override_color`, `convert_shs_python` and
  `compute_cov3d_python` at scaling_modifier 0.7, against JAX's `render`;
- the viewer in training: two `train_rgb` iterations serving a client
  thread give JAX's `_gui_poll` frames within one u8 level;
- the render server that `serve/backend_renderer.py` builds from three
  level checkpoints equals one built on their merge, and answers a ZMQ
  REQ through `.run()` (skipped without zmq or cv2);
- `ViserFrontend._request_for_camera` on a stub camera and stub widgets.
"""
import json
import math
import socket
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from langsplatv2_tpu.eval import lerf as jax_lerf
from langsplatv2_tpu.models import gaussians as jax_gm
from langsplatv2_tpu.models import io as jax_io
from langsplatv2_tpu.models import renderer as jax_renderer
from langsplatv2_tpu.scene.cameras import MiniCam as JaxMiniCam
from langsplatv2_tpu.serve import frontend as jax_frontend
from langsplatv2_tpu.serve import network_gui as jax_gui
from langsplatv2_tpu.train import trainer as jax_trainer
from langsplatv2_tpu_torch.eval.lerf import merge_level_models
from langsplatv2_tpu_torch.eval.openclip import OpenCLIPNetwork
from langsplatv2_tpu_torch.models import io as port_io
from langsplatv2_tpu_torch.models import renderer
from langsplatv2_tpu_torch.models.gaussians import from_numpy_params
from langsplatv2_tpu_torch.scene.cameras import Camera, MiniCam
from langsplatv2_tpu_torch.serve import backend_renderer, frontend
from langsplatv2_tpu_torch.serve import network_gui
from langsplatv2_tpu_torch.serve.backend import BackendRenderer
from langsplatv2_tpu_torch.train import trainer

from scene_fixtures import make_camera

H, W = 40, 56
TOL = 1e-4           # the port's RGB render tests (test_torch_port_slice)


# ------------------------------------------------------ the SIBR protocol

def _message(w, h, train, view, proj, shs=False, cov=False, keep=False,
             scale=1.0):
    return {"resolution_x": w, "resolution_y": h, "train": train,
            "fov_y": 0.8, "fov_x": 1.1, "z_near": 0.01, "z_far": 100.0,
            "shs_python": shs, "rot_scale_python": cov, "keep_alive": keep,
            "scaling_modifier": scale,
            "view_matrix": np.asarray(view, np.float32).reshape(-1).tolist(),
            "view_projection_matrix": np.asarray(
                proj, np.float32).reshape(-1).tolist()}


def _client(port, messages, result):
    """Send each message and read its reply: the raw frame (None at zero
    resolution), then the verify string; close after the last."""
    try:
        s = socket.create_connection(("127.0.0.1", port), timeout=30)

        def recv_exact(n):
            buf = b""
            while len(buf) < n:
                part = s.recv(n - len(buf))
                assert part, "server closed early"
                buf += part
            return buf

        replies = []
        for msg in messages:
            payload = json.dumps(msg).encode("utf-8")
            s.sendall(len(payload).to_bytes(4, "little") + payload)
            n = msg["resolution_x"] * msg["resolution_y"] * 3
            frame = recv_exact(n) if n else None
            verify = recv_exact(int.from_bytes(recv_exact(4), "little"))
            replies.append((frame, verify.decode("ascii")))
        result["replies"] = replies
        s.close()
    except Exception as e:   # surface in the main thread
        result["error"] = repr(e)


def _serve(gui, messages, poll):
    """A client thread for `messages` against `gui` (a network_gui module,
    listening on a free port), accepted before `poll()` is first called;
    `poll()` is called until the client is done and its connection
    dropped."""
    gui.init("127.0.0.1", 0)
    try:
        result = {}
        t = threading.Thread(target=_client, args=(
            gui.listener.getsockname()[1], messages, result))
        t.start()
        for _ in range(500):
            gui.try_connect()
            if gui.conn is not None:
                break
            t.join(timeout=0.01)
        assert gui.conn is not None
        for _ in range(20):
            poll()
            t.join(timeout=0.05)
            if gui.conn is None or "error" in result:
                break
        t.join(timeout=30)
        assert "error" not in result, result.get("error")
        assert gui.conn is None
        return result["replies"]
    finally:
        gui.listener.close()
        gui.listener = gui.conn = None


def test_loopback_matches_jax_bridge():
    """Three requests: zero resolution with train=false (no frame, the
    loop goes on), 32x16 with train=false, 8x4 with train=true (the loop
    lets training go on). Both bridges send the same bytes and hand the
    renderer the same cameras, columns negated."""
    view = np.arange(16, dtype=np.float32).reshape(4, 4) / 7 + np.eye(4)
    proj = np.arange(16, dtype=np.float32).reshape(4, 4)[::-1] / 5
    messages = [_message(0, 0, False, view, proj, keep=True),
                _message(32, 16, False, view, proj, shs=True, scale=0.5),
                _message(8, 4, True, view, proj, cov=True)]
    runs = {}
    for name, gui in (("port", network_gui), ("jax", jax_gui)):
        served = []

        def render_fn(cam, shs_py, cov_py, scaling_mod, served=served):
            served.append((cam, shs_py, cov_py, scaling_mod))
            img = np.zeros((cam.image_height, cam.image_width, 3), np.uint8)
            img[..., 0] = np.arange(cam.image_width)[None] * 7
            img[..., 1] = 200
            return img

        def poll(gui=gui, render_fn=render_fn):
            gui.poll(render_fn, "/data/scene", iteration=1,
                     max_iterations=100)

        runs[name] = (_serve(gui, messages, poll), served)
    (port_replies, port_served), (jax_replies, jax_served) = (runs["port"],
                                                              runs["jax"])
    assert port_replies == jax_replies
    assert [f is None for f, _ in port_replies] == [True, False, False]
    assert all(v == "/data/scene" for _, v in port_replies)
    assert len(port_served) == len(jax_served) == 2
    expect_view, expect_proj = view.copy(), proj.copy()
    expect_view[:, 1:3] *= -1
    expect_proj[:, 1] *= -1
    for (cam, *flags), (jcam, *jflags) in zip(port_served, jax_served):
        assert isinstance(cam, MiniCam)
        assert flags == jflags
        np.testing.assert_array_equal(cam.world_view_transform, expect_view)
        np.testing.assert_array_equal(cam.full_proj_transform, expect_proj)
        np.testing.assert_array_equal(cam.camera_center, jcam.camera_center)
    assert [f[1:] for f in port_served] == [(True, False, 0.5),
                                            (False, True, 1.0)]


def test_dropped_connection_resets_conn():
    """A client that sends half a header and closes: poll drops the
    connection without raising, and polls without a client return at
    once."""
    network_gui.init("127.0.0.1", 0)
    try:
        network_gui.poll(None, "s", 1, 2)          # no client: returns
        assert network_gui.conn is None
        s = socket.create_connection(
            ("127.0.0.1", network_gui.listener.getsockname()[1]))
        s.sendall(b"\x10\x00")
        s.close()
        for _ in range(100):
            network_gui.try_connect()
            if network_gui.conn is not None:
                break
            threading.Event().wait(0.01)
        assert network_gui.conn is not None
        network_gui.poll(None, "s", 1, 2)
        assert network_gui.conn is None
    finally:
        network_gui.listener.close()
        network_gui.listener = network_gui.conn = None
    network_gui.poll(None, "s", 1, 2)              # no listener: returns


# --------------------------------------- camera, covariance, render options

def _sh_scene(n=120, seed=3):
    """n Gaussians at SH degree 1 in front of the camera, as JAX builds
    them, and the same fields in the port."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)),
                          rng.uniform(2.5, 6.0, (n, 1))], 1).astype(np.float32)
    jm = jax_gm.create_from_pcd(pts, rng.uniform(0, 1, (n, 3)).astype(
        np.float32), 1.0, max_sh_degree=1)
    jm = jm.replace(
        opacity=jnp.asarray(rng.uniform(-1, 2, (n, 1)), jnp.float32),
        scaling=jnp.asarray(np.log(rng.uniform(0.05, 0.25, (n, 3))),
                            jnp.float32),
        rotation=jnp.asarray(rng.normal(size=(n, 4)), jnp.float32),
        features_rest=jnp.asarray(0.3 * rng.normal(size=(n, 3, 3)),
                                  jnp.float32),
        active_sh_degree=1)
    fields = {k: np.asarray(getattr(jm, k)) for k in jax_io.MODEL_FIELDS
              if getattr(jm, k) is not None}
    return jm, from_numpy_params(fields, active_sh_degree=1,
                                 max_sh_degree=1, device="cpu")


def _view_proj():
    t = math.radians(5)
    R = np.array([[math.cos(t), 0, math.sin(t)], [0, 1, 0],
                  [-math.sin(t), 0, math.cos(t)]])
    c = make_camera(H, W, R=R, t=np.array([0.1, -0.05, 0.2]))
    return (np.array(c["viewmatrix"]), np.array(c["projmatrix"]),
            math.radians(60), 2 * math.atan(math.tan(math.radians(30)) * W / H))


def test_minicam_and_covariance_match_jax():
    view, proj, fovy, fovx = _view_proj()
    cam = MiniCam(W, H, fovy, fovx, 0.01, 100.0, view, proj)
    ref = JaxMiniCam(W, H, fovy, fovx, 0.01, 100.0, view, proj)
    np.testing.assert_allclose(cam.camera_center, ref.camera_center,
                               rtol=0, atol=0)
    assert (cam.tanfovx, cam.tanfovy) == (ref.tanfovx, ref.tanfovy)
    jm, model = _sh_scene()
    for mod in (1.0, 0.7):
        ref = np.asarray(jm.get_covariance(mod))
        # Off-diagonal entries near cancellation: f32 noise of the largest.
        np.testing.assert_allclose(
            model.get_covariance(mod).detach().numpy(), ref, rtol=1e-5,
            atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("opts", [
    dict(override_color=True), dict(convert_shs_python=True),
    dict(compute_cov3d_python=True),
    dict(convert_shs_python=True, compute_cov3d_python=True),
    dict(override_color=True, convert_shs_python=True,
         compute_cov3d_python=True)],
    ids=["override", "shs", "cov3d", "shs-cov3d", "all"])
def test_render_options_match_jax(opts):
    """At scaling_modifier 0.7: JAX's get_covariance applies it, and its
    preprocess takes cov3d_precomp as given; so does the port's. The
    override colour wins over the SH colours in both."""
    jm, model = _sh_scene()
    view, proj, fovy, fovx = _view_proj()
    cam = MiniCam(W, H, fovy, fovx, 0.01, 100.0, view, proj)
    colors = np.random.default_rng(9).uniform(
        0, 1, (model.capacity, 3)).astype(np.float32)
    kw = dict(opts)
    jkw = dict(opts)
    if kw.pop("override_color", False):
        jkw["override_color"] = jnp.asarray(colors)
        kw["override_color"] = torch.from_numpy(colors)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    out = renderer.render(renderer.make_settings(cam, 1, 0.7, 2 ** 14), model,
                          view, proj, cam.camera_center, bg, device="cpu",
                          **kw)
    ref = jax_renderer.render(
        jax_renderer.make_settings(cam, 1, 0.7, 2 ** 14, 256, 16), jm,
        jnp.asarray(view), jnp.asarray(proj),
        jnp.asarray(cam.camera_center, jnp.float32), jnp.asarray(bg), **jkw)
    np.testing.assert_allclose(out.render.numpy(), np.asarray(ref.render),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(ref.radii))
    # The options change the frame: the comparison is not of a default
    # render.
    plain = renderer.render(renderer.make_settings(cam, 1, 1.0, 2 ** 14),
                            model, view, proj, cam.camera_center, bg,
                            device="cpu")
    assert float((out.render - plain.render).abs().max()) > 1e-2
    both = renderer.render_camera(cam, model, bg, scaling_modifier=0.7,
                                  max_entries=2 ** 14, device="cpu", **kw)
    torch.testing.assert_close(both.render, out.render, atol=0, rtol=0)


# ------------------------------------------------------ viewer in training

def _opt():
    return types.SimpleNamespace(
        iterations=2, position_lr_init=0.00016, position_lr_final=0.0000016,
        position_lr_delay_mult=0.01, position_lr_max_steps=30_000,
        feature_lr=0.0025, opacity_lr=0.05, scaling_lr=0.005,
        rotation_lr=0.001, percent_dense=0.01, lambda_dssim=0.2,
        densification_interval=100, opacity_reset_interval=3000,
        densify_from_iter=500, densify_until_iter=0,
        densify_grad_threshold=0.0002)


def test_training_serves_jax_frames():
    """train_rgb(gui_source_path=...) for two iterations with a viewer:
    at the top of iteration 1 a client asks for a frame with the Python
    SH colours and covariances at scaling_modifier 0.7, one with neither,
    then lets training go on and closes. Each frame is within one u8
    level of the one JAX's _gui_poll serves for the same model and
    request, and the verify string is the source path."""
    jm, model = _sh_scene()
    view, proj, fovy, fovx = _view_proj()
    sent_view, sent_proj = view.copy(), proj.copy()
    sent_view[:, 1:3] *= -1            # the bridge negates them back
    sent_proj[:, 1] *= -1
    messages = [
        _message(W, H, False, sent_view, sent_proj, shs=True, cov=True,
                 keep=True, scale=0.7),
        _message(W, H, False, sent_view, sent_proj, keep=True),
        _message(W, H, True, sent_view, sent_proj, keep=True)]
    messages = [dict(m, fov_y=fovy, fov_x=fovx) for m in messages]
    rng = np.random.default_rng(5)
    cams = [Camera(i, np.eye(3), np.array([0.1 * i, -0.05, 0.2]), fovx,
                   fovy, rng.uniform(0, 1, (3, H, W)).astype(np.float32),
                   f"c{i}", i) for i in range(2)]
    bg = (0.0, 0.0, 0.0)
    losses = []

    def train():
        losses.append(trainer.train_rgb(
            model, cams, _opt(), 2.0, iterations=2, bg_color=bg,
            max_entries=2 ** 14, gui_source_path="/scenes/s",
            device="cpu")[2].losses)

    port = _serve(network_gui, messages, train)
    assert len(losses[0]) == 2
    jax_frames = _serve(jax_gui, messages, lambda: jax_trainer._gui_poll(
        jm, jnp.asarray(bg, jnp.float32), 1, 2, "/scenes/s", 2 ** 14, 256))
    assert [v for _, v in port] == ["/scenes/s"] * 3
    for (frame, _), (jframe, _) in zip(port[:2], jax_frames[:2]):
        a = np.frombuffer(frame, np.uint8).reshape(H, W, 3).astype(int)
        b = np.frombuffer(jframe, np.uint8).reshape(H, W, 3).astype(int)
        assert np.abs(a - b).max() <= 1
        assert a.max() > 50
    assert port[0][0] != port[1][0]     # the options change the frame


# ------------------------------------------------------------ render server

@pytest.fixture(scope="module")
def level_dirs(tmp_path_factory):
    """Three level checkpoints (40 splats, one layer of 64 codes each)
    written by JAX's save_checkpoint."""
    root = tmp_path_factory.mktemp("levels")
    n = 40
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([np.cos(ang), np.sin(ang), np.full(n, 5.0)],
                   1).astype(np.float32)
    dirs = []
    for lvl in range(3):
        m = jax_gm.create_from_pcd(pts, np.full((n, 3), 0.5, np.float32), 1.0)
        m = m.replace(opacity=jnp.full((n, 1), 1.5))
        m = jax_gm.init_language_features(m, jax.random.PRNGKey(lvl), 1, 64)
        d = root / f"s_1_{lvl + 1}"
        jax_io.save_checkpoint(str(d / "chkpnt10.npz"), m, None, 10)
        dirs.append(str(d))
    return dirs


def _request():
    c2w = np.eye(4)
    c2w[0, 3] = 0.1
    return {"c2w": c2w.tolist(), "width": 96, "height": 64,
            "fov_y": math.radians(60), "prompt": "red car",
            "show_heatmap": True, "threshold": 0.1}


def _cli_argv(dirs, *extra):
    return ["--ckpt_paths", *dirs, "--iteration", "10", "--clip_backend",
            "hash", "--device", "cpu", *extra]


@pytest.mark.parametrize("extra,kw", [
    ((), {}), (("--tile_budget", "1e-6", "--tile_budget_cap", "128"),
               dict(tile_budget=1e-6, tile_budget_cap=128)),
    (("--bf16_cells",), dict(bf16_cells=True))],
    ids=["exact", "capped", "bf16_cells"])
def test_cli_server_matches_direct_server(level_dirs, extra, kw):
    server = backend_renderer.make_server(_cli_argv(level_dirs, *extra),
                                          compose="device")
    models = [port_io.load_checkpoint(f"{d}/chkpnt10.npz", device="cpu")[0]
              for d in level_dirs]
    direct = BackendRenderer(merge_level_models(models),
                             clip_model=OpenCLIPNetwork("hash",
                                                        device="cpu"),
                             compose="device", device="cpu",
                             **{"tile_budget_cap": 256, **kw})
    assert (server.tile_budget, server.tile_budget_cap,
            server.bf16_cells) == (direct.tile_budget,
                                   direct.tile_budget_cap, direct.bf16_cells)
    a = server.finalize_frame(server.dispatch_request(_request()),
                              as_uint8=True)
    b = direct.finalize_frame(direct.dispatch_request(_request()),
                              as_uint8=True)
    assert a.shape == (64, 96, 3)
    np.testing.assert_array_equal(a, b)
    # JAX's merge of the same checkpoints holds the same quick pairs.
    jm = jax_lerf.merge_level_models([jax_io.load_checkpoint_auto(
        f"{d}/chkpnt10.npz")[0] for d in level_dirs])
    np.testing.assert_array_equal(server.model.quick_indices.numpy(),
                                  np.asarray(jm.quick_indices))


def test_cli_server_answers_zmq(level_dirs):
    """main's server loop (`.run()`, REQ/REP, host compose) in a daemon
    thread answers a request with a JPEG of the requested size."""
    zmq = pytest.importorskip("zmq")
    cv2 = pytest.importorskip("cv2")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = backend_renderer.make_server(_cli_argv(
        level_dirs, "--zmq_port", str(port)))
    threading.Thread(target=server.run, daemon=True).start()
    ctx = zmq.Context()
    req = ctx.socket(zmq.REQ)
    req.setsockopt(zmq.LINGER, 0)
    req.setsockopt(zmq.RCVTIMEO, 60_000)
    req.connect(f"tcp://localhost:{port}")
    try:
        req.send(json.dumps(_request()).encode())
        reply = req.recv()
    finally:
        req.close()
        ctx.term()
    img = cv2.imdecode(np.frombuffer(reply, np.uint8), cv2.IMREAD_COLOR)
    assert img is not None and img.shape == (64, 96, 3)


# ------------------------------------------------------------------- viser

def test_viser_request_matches_jax():
    """The request for a stub viser camera and stub widgets (viser is not
    installed, so the frontend is built without its constructor)."""
    camera = types.SimpleNamespace(
        wxyz=np.array([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm(
            [0.9, 0.1, -0.3, 0.2]),
        position=np.array([0.5, -1.0, 2.0]), fov=0.9, aspect=1.5)

    def widgets(fe):
        fe.base_height = 720
        fe.gui_res = types.SimpleNamespace(value=3)
        fe.gui_prompt = types.SimpleNamespace(value="teddy bear")
        fe.gui_threshold = types.SimpleNamespace(value=0.31)
        fe.gui_heatmap = types.SimpleNamespace(value=True)
        return fe

    port = widgets(object.__new__(frontend.ViserFrontend))
    ref = widgets(object.__new__(jax_frontend.ViserFrontend))
    assert port._request_for_camera(camera) == ref._request_for_camera(camera)
    with pytest.raises(ImportError):
        frontend.ViserFrontend()
