"""The program's spans and counters (no JAX counterpart).

`span(name)` marks a layer of a frame or a training step with a
torch.profiler host range "lsv2.<name>", entered only while a profiler
session records in this process (the profiler's own flag): outside one it
returns a shared no-op context and costs one attribute read. Being the
profiler's own ranges, the spans share the trace's clock with the CUDA
launches and device records, so a device operation belongs to the spans
open at its launch and an idle gap of the device to the span the host was
in when the gap began. Spans nest on the thread that opens them: a frame's
layers under "lsv2.render", a training step's phases under "lsv2.step".

`count(name, n)` adds to one process-wide registry of integer counters;
`counters()` returns a copy of it.

Spans: render (models/renderer.py), preprocess, binning, blend, assemble
(each route of ops/rasterize.py, parallel/gauss_sharded.py),
preprocess_bwd (the preprocess's backward launch, ops/projection.py;
inside the step's backward), query
(eval/openclip.py), topk_codes (models/gaussians.py), step, forward, loss,
accept, backward, optimizer (train/trainer.py, both feature step makers),
and of the geometry phase (train/trainer.py): step over forward, loss,
backward, optimizer and densify_stats (`rgb_step`), and densify and
opacity_reset beside it (`rgb_iteration`). Counters: k1.launches,
k1.alpha_launches, k1.nocull_launches (ops/expand.py),
preprocess.launches (each launch of the preprocess kernel),
preprocess.grad_launches (each launch of its backward kernel) and
preprocess.plain_calls (each plain preprocess on CUDA tensors)
(ops/projection.py), topk_codes.launches (each launch of the top-k
codes kernel, forward and backward; ops/topk_codes.py),
feature_step.redone, densify.rounds,
densify.capacity_growths, densify.placed and densify.pruned
(train/trainer.py `run_densify`: rounds, growths, new Gaussians and
removed ones).
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.autograd import profiler as _profiler

PREFIX = "lsv2."
_OFF = contextlib.nullcontext()
_COUNTERS: dict[str, int] = {}
_LOCK = threading.Lock()    # a render server counts from its threads


def span(name: str):
    """A context manager: the host range PREFIX + name while a
    torch.profiler session records, else a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (created at 0)."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of every counter's value."""
    with _LOCK:
        return dict(_COUNTERS)
