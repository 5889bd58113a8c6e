"""The SIBR remote viewer's bridge, a non-blocking TCP listener
(port of langsplatv2_tpu/serve/network_gui.py; reference
gaussian_renderer/network_gui.py:43-86). Standard library and numpy.

The wire protocol of 3DGS's SIBR viewer: each request is a 4-byte
little-endian length, then a UTF-8 JSON object with resolution_x/y, train,
fov_y/x, z_near/far, shs_python, rot_scale_python, keep_alive,
scaling_modifier and the flattened view and view-projection matrices
(the receiver negates columns 1 and 2 of the view matrix and column 1 of
the projection, the viewer's convention). The reply is the raw H*W*3 u8
RGB frame, then the length-prefixed verification string (the scene's
source path). The training loops call `poll` at the top of each
iteration (reference train.py:115-128). The listener and the connection
are module state, as in the reference: `init` opens the listener.
"""
from __future__ import annotations

import json
import socket

import numpy as np

from ..scene.cameras import MiniCam

host = "127.0.0.1"
port = 55557
conn = None
addr = None
listener = None


def init(wish_host: str, wish_port: int) -> None:
    """Listen on (wish_host, wish_port), without blocking; port 0 takes a
    free port (read it from `listener.getsockname()`)."""
    global host, port, listener
    host, port = wish_host, wish_port
    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen()
    listener.settimeout(0)


def try_connect() -> None:
    """Accept a pending client, if there is one."""
    global conn, addr
    try:
        conn, addr = listener.accept()
        print(f"\nConnected by {addr}")
        conn.settimeout(None)
    except Exception:
        pass


def _recv_exact(n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = conn.recv(n - len(buf))
        if not part:
            raise ConnectionError("SIBR client closed the connection")
        buf += part
    return buf


def read() -> dict:
    message_length = int.from_bytes(_recv_exact(4), "little")
    return json.loads(_recv_exact(message_length).decode("utf-8"))


def send(message_bytes: bytes | None, verify: str) -> None:
    if message_bytes is not None:
        conn.sendall(message_bytes)
    conn.sendall(len(verify).to_bytes(4, "little"))
    conn.sendall(bytes(verify, "ascii"))


def receive():
    """One request: (MiniCam | None, do_training, convert_shs_python,
    compute_cov3d_python, keep_alive, scaling_modifier). A request at zero
    resolution (a minimized viewer) has no camera, but its flags still
    count, or the training loop's poll could never let training go on."""
    message = read()
    width = int(message["resolution_x"])
    height = int(message["resolution_y"])
    do_training = bool(message["train"])
    fovy = float(message["fov_y"])
    fovx = float(message["fov_x"])
    znear = float(message["z_near"])
    zfar = float(message["z_far"])
    do_shs_python = bool(message["shs_python"])
    do_rot_scale_python = bool(message["rot_scale_python"])
    keep_alive = bool(message["keep_alive"])
    scaling_modifier = float(message["scaling_modifier"])
    if width == 0 or height == 0:
        return (None, do_training, do_shs_python, do_rot_scale_python,
                keep_alive, scaling_modifier)
    world_view = np.asarray(message["view_matrix"], np.float32).reshape(4, 4)
    world_view[:, 1] = -world_view[:, 1]
    world_view[:, 2] = -world_view[:, 2]
    full_proj = np.asarray(message["view_projection_matrix"],
                           np.float32).reshape(4, 4)
    full_proj[:, 1] = -full_proj[:, 1]
    custom_cam = MiniCam(width, height, fovy, fovx, znear, zfar, world_view,
                         full_proj)
    return (custom_cam, do_training, do_shs_python, do_rot_scale_python,
            keep_alive, scaling_modifier)


def poll(render_fn, source_path: str, iteration: int, max_iterations: int):
    """One poll of the training loop (reference train.py:115-128): accept
    a pending client, then serve its requests until it lets training go
    on; an error drops the connection. `render_fn(MiniCam,
    convert_shs_python, compute_cov3d_python, scaling_modifier)` returns
    the [H, W, 3] u8 frame. Never raises, and never blocks without a
    client."""
    global conn
    if listener is None:
        return
    if conn is None:
        try_connect()
    while conn is not None:
        try:
            net_image_bytes = None
            (custom_cam, do_training, shs_py, cov_py, keep_alive,
             scaling_mod) = receive()
            if custom_cam is not None:
                img = render_fn(custom_cam, shs_py, cov_py, scaling_mod)
                net_image_bytes = memoryview(np.ascontiguousarray(img))
            send(net_image_bytes, source_path)
            if do_training and (iteration < max_iterations or not keep_alive):
                break
        except Exception:
            conn = None
