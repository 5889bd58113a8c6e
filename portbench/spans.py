"""The program's spans in the traced run: its "lsv2.*" host ranges
(langsplatv2_tpu_torch/tracing.py), read from the same Chrome trace as
trace.read, on the same clock as the device's records.

For each span name, over the traced calls:

- `device_s`: the device time of every operation launched while a span of
  that name was open, its children's included. A launch belongs to the
  spans open at its host time, whatever thread launched it (autograd's
  worker launches the backward's kernels inside the caller's
  "lsv2.backward"). An operation whose launch the trace lacks takes the
  spans of the operation before it on its stream, as trace.read does.
- `idle_s`: the device idle of the gaps (trace.read's, inside the window)
  that begin while that span is the innermost open "lsv2.*" span.
- `host_s`: the spans' self time, their length less their children's on
  the thread that opened them.
- `ops`: the count of device operations launched inside such a span.

CALLER holds the operations launched inside no span (`device_s`, `ops`)
and the gaps that begin inside none (`idle_s`), so the idle of the spans'
innermost attribution and CALLER's sums to the window's idle.

A span is open on [start, end): a launch at a span's end is outside it.
"""
from __future__ import annotations

import bisect
import sys
import weakref

import torch

from portbench import trace

PREFIX = "lsv2."
CALLER = "caller"
_READ = weakref.WeakKeyDictionary()     # a traced run's Tracer -> its spans


def read_spans(events: list) -> dict:
    """{span name without the prefix: {device_s, idle_s, host_s, ops}} and
    CALLER; {} when the trace holds no "lsv2.*" range."""
    steps = [e for e in events if e.get("ph") == "X"
             and e.get("name", "").startswith("ProfilerStep#")]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):],
                     e.get("tid")) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(PREFIX)),
                   key=lambda s: (s[0], -s[1]))
    if not steps or not spans:
        return {}
    w0 = min(e["ts"] for e in steps)
    w1 = max(e["ts"] + e["dur"] for e in steps)
    out = {name: dict(device_s=0.0, idle_s=0.0, host_s=0.0, ops=0)
           for _, _, name, _ in spans}
    out[CALLER] = dict(device_s=0.0, idle_s=0.0, ops=0)
    # Self time: each span's length less its direct children's on its own
    # thread (a stack over the spans in start order).
    stacks: dict = {}
    for t0, t1, name, tid in spans:
        stack = stacks.setdefault(tid, [])
        while stack and stack[-1][1] <= t0:
            stack.pop()
        out[name]["host_s"] += (t1 - t0) * 1e-6
        if stack:
            out[stack[-1][2]]["host_s"] -= (t1 - t0) * 1e-6
        stack.append((t0, t1, name))
    # The spans open on each stretch between two consecutive boundaries,
    # innermost (latest start) last.
    bounds = sorted({t for s in spans for t in s[:2]})
    open_at = [tuple(name for t0, t1, name, _ in spans if t0 <= b < t1)
               for b in bounds]

    def inside(t):
        i = bisect.bisect_right(bounds, t) - 1
        return () if i < 0 else open_at[i]

    launch = {}
    for e in events:
        if e.get("cat") in trace.LAUNCH_CATS and \
                "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e["ts"]
    device = sorted((e for e in events if e.get("ph") == "X"
                     and e.get("cat") in trace.DEVICE_CATS),
                    key=lambda e: e["ts"])
    last: dict = {}
    busy = []
    for d in device:
        args = d.get("args", {})
        t = launch.get(args.get("correlation"))
        names = inside(t) if t is not None else last.get(args.get("stream"),
                                                         ())
        last[args.get("stream")] = names
        for name in set(names) or (CALLER,):
            out[name]["device_s"] += d["dur"] * 1e-6
            out[name]["ops"] += 1
        s, e = max(d["ts"], w0), min(d["ts"] + d["dur"], w1)
        if e > s:
            busy.append((s, e))
    # The idle gaps of the window (trace.read's), each to the innermost
    # span open at its start.
    end = w0
    for s, e in sorted(busy) + [(w1, w1)]:
        if s > end:
            names = inside(end)
            out[names[-1] if names else CALLER]["idle_s"] += (s - end) * 1e-6
        end = max(end, e)
    return out


def _category(e) -> str:
    """The Chrome trace's category of a profiler record, from what every
    torch 2 record exposes: device records are annotations or operations,
    host records annotations, CUDA API calls (named cu*) or operators."""
    if e.device_type() != torch.autograd.DeviceType.CPU:
        return "gpu_user_annotation" if e.is_user_annotation() else "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    return "cuda_runtime" if e.name().startswith("cu") else "cpu_op"


def profile_events(prof) -> list:
    """A finished torch.profiler.profile's records as the Chrome trace's
    events (name, cat, ts and dur in us, tid, the correlation and stream
    in args), from its results object: a profile saves its trace file
    once, and run.py has read and deleted that file. Times count from the
    first record, so that a double keeps their nanoseconds."""
    records = prof.profiler.kineto_results.events()
    t0 = min((e.start_ns() for e in records), default=0)
    return [{"ph": "X", "name": e.name(), "cat": _category(e),
             "ts": (e.start_ns() - t0) * 1e-3, "dur": e.duration_ns() * 1e-3,
             "tid": e.start_thread_id(),
             "args": {"correlation": e.correlation_id(),
                      "stream": e.device_resource_id()}}
            for e in records]


def _traced_run_spans():
    """The spans of the traced run whose metrics are being read, or None.
    run.py hands a metric's reader the entry's layer record, which holds
    no spans: they are read from the profiler of the Tracer that a
    calling frame holds."""
    f = sys._getframe(1)
    while f is not None:
        tracer = next((v for v in f.f_locals.values()
                       if isinstance(v, trace.Tracer)), None)
        if tracer is not None:
            break
        f = f.f_back
    else:
        return None
    if tracer not in _READ:
        try:
            _READ[tracer] = read_spans(profile_events(tracer.prof))
        except AttributeError:     # a torch whose records lack these fields
            _READ[tracer] = {}
    return _READ[tracer]


def of(rec: dict):
    """The spans of a per-layer record: its "spans" key, else the traced
    run's; None when neither holds an "lsv2.*" span (a program without
    spans)."""
    spans = rec["spans"] if "spans" in rec else _traced_run_spans()
    return spans or None


def per_call_ms(rec: dict, name: str, key: str):
    """1e3 * spans[name][key] over the record's traced calls, or None when
    the record holds no spans or none named so."""
    spans = of(rec)
    if spans is None or name not in spans:
        return None
    return 1e3 * spans[name][key] / rec["calls"]
