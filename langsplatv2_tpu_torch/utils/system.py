"""Process-level state (port of langsplatv2_tpu/utils/system.py).

`safe_state` (reference utils/general_utils.py:112-133) timestamps every
line written to stdout, or silences stdout, and seeds Python's, numpy's
and torch's generators. It replaces `sys.stdout` and returns the stream it
replaced, so that a caller running in process can put it back.
"""
from __future__ import annotations

import random
import sys
from datetime import datetime

import numpy as np
import torch


class _TimestampedStream:
    def __init__(self, stream, silent: bool):
        self.stream = stream
        self.silent = silent

    def write(self, text: str):
        if self.silent:
            return
        if text.endswith("\n"):
            stamp = datetime.now().strftime("%d/%m %H:%M:%S")
            text = text.replace("\n", f" [{stamp}]\n")
        self.stream.write(text)

    def flush(self):
        self.stream.flush()

    def __getattr__(self, name):
        return getattr(self.stream, name)


def safe_state(silent: bool = False, seed: int = 0):
    """Timestamp stdout lines (drop them when `silent`) and seed the host
    generators and torch's default ones. Returns the previous sys.stdout."""
    previous = sys.stdout
    sys.stdout = _TimestampedStream(previous, silent)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return previous
