"""The traced run: torch.profiler over a stretch of the window, read back
from its Chrome trace into one record that the per-layer readers take
numbers from.

The benchmark marks its own calls with record_function ranges (one a
frame or step, "portbench.call") and hands the program a stage list whose
append leaves a zero-length "portbench.stage.<name>" mark beside the
program's CUDA event. A device operation belongs to the call and stage in
which the host launched it (the launch's runtime event, matched by
correlation id), whatever its name.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile

import torch

STAGE = "portbench.stage."
CALL = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 160          # a device operation's name, as the breakdown keeps it


class StageLog(list):
    """The program's `stage_events` list: each (name, event) it appends
    also leaves a mark in the trace at the host time of the append."""

    def append(self, item):
        with torch.profiler.record_function(STAGE + item[0]):
            pass
        super().append(item)


class Tracer:
    """Profiles calls wait..wait+active of the window (after `warmup`
    calls with the profiler on and nothing kept) and keeps the trace."""

    def __init__(self, wait: int, warmup: int, active: int):
        self.active = active
        self.path = None
        self.traced_calls = []           # the call numbers profiled

        def ready(prof):
            fd, self.path = tempfile.mkstemp(suffix=".json",
                                             prefix="portbench_trace_")
            os.close(fd)
            prof.export_chrome_trace(self.path)

        self.first = wait + warmup
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=wait, warmup=warmup,
                                             active=active, repeat=1),
            on_trace_ready=ready)
        self.calls = 0

    def __enter__(self):
        # The first profiling session of a process starts CUPTI, which took
        # ~11 s on the card beside the 1080p cell's state: a session of its
        # own here keeps that stall out of the window.
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda" if torch.cuda.is_available()
                       else "cpu").sum()
        self.prof.__enter__()
        return self

    @property
    def complete(self) -> bool:
        return len(self.traced_calls) >= self.active

    def step(self, tag=None) -> None:
        """After each call of the window; `tag` is kept for the profiled
        ones (what the call worked on)."""
        if self.first <= self.calls < self.first + self.active:
            self.traced_calls.append(tag)
        self.calls += 1
        self.prof.step()

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def events(self) -> list:
        if self.path is None or not self.complete:
            raise RuntimeError("the profiler kept no trace: the window "
                               f"ran {self.calls} calls, fewer than "
                               f"{self.first + self.active}")
        try:
            with open(self.path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.unlink(self.path)


def _union(intervals) -> float:
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _innermost(host: list, starts: list, t: float) -> str:
    """The latest-starting host range open at t (ranges nest, so it is the
    innermost), looking back over at most 4,096 ranges."""
    i = bisect.bisect_right(starts, t)
    for h in reversed(host[max(0, i - 4096):i]):
        if h["ts"] + h["dur"] > t:
            return h["name"]
    return "(host outside any range)"


def read(events: list) -> dict:
    """The record: `window_s` (the profiled steps' host span), `busy_s`
    (device time with some operation running, inside the window),
    `calls` [{stage: device seconds}] for each marked call in order,
    `ops` {device op name: seconds}, `gaps` {host activity: idle seconds}
    (the device's idle gaps by the innermost benchmark or program range
    the host was in at the gap's start)."""
    steps = [e for e in events if e.get("ph") == "X"
             and e.get("name", "").startswith("ProfilerStep#")]
    if not steps:
        raise RuntimeError("the trace holds no profiler step")
    w0 = min(e["ts"] for e in steps)
    w1 = max(e["ts"] + e["dur"] for e in steps)
    launch = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e["ts"]
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    # Host-side ranges only: the trace also draws each range again on the
    # device's timeline ("gpu_user_annotation").
    host_ranges = [e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"]
    calls = sorted((e["ts"], e["ts"] + e["dur"]) for e in host_ranges
                   if e["name"] == CALL)
    marks = sorted((e["ts"], e["name"][len(STAGE):]) for e in host_ranges
                   if e["name"].startswith(STAGE))
    per_call = [dict() for _ in calls]
    ops: dict = {}
    spans = []
    # A device operation whose launch the trace does not hold (the port's
    # kernels are launched through their library's own runtime) takes the
    # call and stage of the operation before it on its stream: a stream
    # runs its operations in launch order.
    last: dict = {}
    unmatched = 0
    for d in sorted(device, key=lambda d: d["ts"]):
        dur = d["dur"] * 1e-6
        ops[d["name"]] = ops.get(d["name"], 0.0) + dur
        s, e = max(d["ts"], w0), min(d["ts"] + d["dur"], w1)
        if e > s:
            spans.append((s, e))
        args = d.get("args", {})
        stream = args.get("stream")
        t = launch.get(args.get("correlation"))
        where = None
        if t is not None:
            for i, (c0, c1) in enumerate(calls):
                if c0 <= t <= c1:
                    stage = next((name for ts, name in marks
                                  if c0 <= ts <= c1 and ts >= t), "tail")
                    where = (i, stage)
                    break
        else:
            unmatched += 1
            where = last.get(stream)
        last[stream] = where
        if where is not None:
            i, stage = where
            per_call[i][stage] = per_call[i].get(stage, 0.0) + dur
    busy = _union(spans)
    # Idle gaps inside the window, each put down to the innermost host
    # range (user annotation or operator) running at its start.
    host = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") in ("user_annotation", "cpu_op")
                   and not e.get("name", "").startswith(
                       ("ProfilerStep#", STAGE))), key=lambda e: e["ts"])
    starts = [h["ts"] for h in host]
    gaps: dict = {}
    end = w0
    for s, e in sorted(spans) + [(w1, w1)]:
        if s > end:
            name = _innermost(host, starts, end)
            gaps[name] = gaps.get(name, 0.0) + (s - end) * 1e-6
        end = max(end, e)
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                calls=per_call, ops=ops, gaps=gaps, unmatched=unmatched,
                device_ops=len(device))


def breakdown(rec: dict) -> dict:
    """The result line's breakdown: the ten device operations that took
    most time and the ten host activities with the most device idle."""
    top = sorted(rec["ops"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(rec["gaps"].items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[k[:NAME_CHARS], v] for k, v in top],
                idle_gaps=[[k[:NAME_CHARS], v] for k, v in gaps])
