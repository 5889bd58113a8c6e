"""Client side of the render server (port of langsplatv2_tpu/serve/frontend.py;
reference frontend_viser.py): `wxyz_to_rotmat`, `PipelinedClient` and the
viser web GUI, `ViserFrontend` (a prompt box, a threshold slider, a
heatmap toggle and a resolution divisor; a 100 Hz loop sends each
client's camera to the server and paints the JPEG it returns as the
background). `zmq` and `viser` are imported when a client is made, and
the JPEG is decoded with PIL.
"""
from __future__ import annotations

import io
import json
import time

import numpy as np


def wxyz_to_rotmat(wxyz) -> np.ndarray:
    """Quaternion (w, x, y, z) -> rotation matrix (reference
    frontend_viser.py:104-117)."""
    w, x, y, z = wxyz
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


class PipelinedClient:
    """DEALER client for BackendRenderer.run_pipelined: keeps up to `depth`
    requests in flight. `submit` enqueues; `collect` returns the oldest
    reply (bytes) when one is due."""

    def __init__(self, backend_addr: str = "tcp://localhost:5555",
                 depth: int = 2):
        import zmq

        self._ctx = zmq.Context()
        self.socket = self._ctx.socket(zmq.DEALER)
        self.socket.connect(backend_addr)
        self.depth = depth
        self.inflight = 0

    def submit(self, request: dict):
        self.socket.send_multipart([b"", json.dumps(request).encode()])
        self.inflight += 1

    def _recv(self) -> bytes:
        _empty, reply = self.socket.recv_multipart()
        self.inflight -= 1
        return reply

    def collect(self, block: bool = False) -> bytes | None:
        """Oldest outstanding reply; None when the pipeline is not full yet
        (or, with block=False, when no reply is ready)."""
        if self.inflight > self.depth or (block and self.inflight):
            return self._recv()
        if self.inflight and self.socket.poll(0):
            return self._recv()
        return None

    def drain(self):
        while self.inflight:
            yield self._recv()


class ViserFrontend:
    def __init__(self, backend_addr: str = "tcp://localhost:5555",
                 port: int = 8081, base_height: int = 720,
                 fov_y: float = 1.0):
        import viser
        import zmq

        self.server = viser.ViserServer(port=port)
        ctx = zmq.Context()
        self.socket = ctx.socket(zmq.REQ)
        self.socket.connect(backend_addr)
        self.base_height = base_height
        self.fov_y = fov_y

        self.gui_prompt = self.server.gui.add_text("Prompt", initial_value="")
        self.gui_threshold = self.server.gui.add_slider(
            "Threshold", min=0.0, max=1.0, step=0.01, initial_value=0.22)
        self.gui_heatmap = self.server.gui.add_checkbox(
            "Show heatmap", initial_value=False)
        self.gui_res = self.server.gui.add_slider(
            "Resolution divisor", min=1, max=8, step=1, initial_value=2)

    def _request_for_camera(self, camera) -> dict:
        """A viser camera (wxyz, position, fov, aspect) and the widgets'
        values -> the server's request dict."""
        c2w = np.eye(4)
        c2w[:3, :3] = wxyz_to_rotmat(np.asarray(camera.wxyz))
        c2w[:3, 3] = np.asarray(camera.position)
        height = self.base_height // int(self.gui_res.value)
        return {
            "c2w": c2w.tolist(),
            "width": int(height * camera.aspect),
            "height": height,
            "fov_y": float(camera.fov),
            "prompt": self.gui_prompt.value,
            "threshold": float(self.gui_threshold.value),
            "show_heatmap": bool(self.gui_heatmap.value),
        }

    def run(self, poll_hz: float = 100.0):
        from PIL import Image

        while True:
            for client in self.server.get_clients().values():
                req = self._request_for_camera(client.camera)
                self.socket.send(json.dumps(req).encode())
                reply = self.socket.recv()
                if reply == b"ERROR":
                    continue
                with Image.open(io.BytesIO(reply)) as im:
                    img = np.asarray(im.convert("RGB"))
                client.scene.set_background_image(img)
            time.sleep(1.0 / poll_hz)
