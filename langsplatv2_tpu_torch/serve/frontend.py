"""Client side of the render server (port of langsplatv2_tpu/serve/frontend.py:
`wxyz_to_rotmat` and `PipelinedClient`).

The viser web GUI (`ViserFrontend`) belongs to a later slice of the port
(ROADMAP.md Queue 1 item 9). `zmq` is imported when a client is made.
"""
from __future__ import annotations

import json

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
