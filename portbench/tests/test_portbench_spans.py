"""The program's spans read from a hand-made Chrome trace (portbench/
spans.py): nested "lsv2.*" ranges, a launch from a second thread, a
device operation whose launch is missing, idle gaps inside and outside
the spans; every span metric's reader reads a value from such a record,
and none from a record of a program without spans; a CPU traced run's
readers find the spans through the run's Tracer."""
import pytest
import torch

from portbench import common, spans, trace

US = 1e-6


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _events():
    """Main thread 1: step [10, 155) over forward (render: top-k codes,
    preprocess, binning, blend), loss, accept, backward, optimizer; then
    query [155, 175). Thread 2 (autograd's) launches inside the backward.
    Kernel k3 has no launch in the trace; k8 is launched outside every
    span."""
    ev = [_x("ProfilerStep#1", "user_annotation", 0, 200),
          _x(trace.CALL, "user_annotation", 1, 189),
          _x("lsv2.render", "gpu_user_annotation", 20, 30),
          _x("aten::mul", "cpu_op", 31, 2)]
    ranges = [("step", 10, 145), ("forward", 10, 50), ("render", 12, 46),
              ("topk_codes", 12, 2), ("preprocess", 14, 14),
              ("binning", 28, 2), ("blend", 30, 20), ("loss", 60, 10),
              ("accept", 70, 20), ("backward", 90, 40),
              ("optimizer", 130, 20), ("query", 155, 20)]
    ev += [_x("lsv2." + n, "user_annotation", ts, d) for n, ts, d in ranges]
    launches = [(1, 15, 1), (2, 35, 1), (4, 65, 1), (5, 100, 2), (6, 140, 1),
                (7, 160, 1), (8, 180, 1)]
    ev += [_x("cudaLaunchKernel", "cuda_runtime", ts, 1, tid, correlation=c)
           for c, ts, tid in launches]
    kernels = [(1, 20, 10), (2, 35, 10), (99, 46, 4), (4, 66, 6),
               (5, 101, 20), (6, 141, 5), (7, 161, 9), (8, 181, 4)]
    ev += [_x(f"k{c}", "kernel", ts, d, correlation=c, stream=7)
           for c, ts, d in kernels]
    return ev


WANT = {  # name: (device us, idle us, host us, ops)
    "step": (55, 0, 5, 6), "forward": (24, 0, 4, 3),
    "render": (24, 16, 8, 3), "topk_codes": (0, 0, 2, 0),
    "preprocess": (10, 0, 14, 1), "binning": (0, 0, 2, 0),
    "blend": (14, 6, 20, 2), "loss": (6, 0, 10, 1), "accept": (0, 29, 20, 0),
    "backward": (20, 20, 40, 1), "optimizer": (5, 15, 20, 1),
    "query": (9, 11, 20, 1), spans.CALLER: (4, 35, None, 1)}


def test_read_spans_exact():
    got = spans.read_spans(_events())
    assert set(got) == set(WANT)
    for name, (dev, idle, host, ops) in WANT.items():
        g = got[name]
        assert g["device_s"] == pytest.approx(dev * US, abs=1e-12), name
        assert g["idle_s"] == pytest.approx(idle * US, abs=1e-12), name
        assert g["ops"] == ops, name
        if host is not None:
            assert g["host_s"] == pytest.approx(host * US, abs=1e-12), name
    # The idle partition is the window's idle, as trace.read counts it.
    rec = trace.read(_events())
    idle = sum(g["idle_s"] for g in got.values())
    assert idle == pytest.approx(rec["window_s"] - rec["busy_s"], abs=1e-12)
    assert spans.read_spans([e for e in _events()
                             if not e["name"].startswith("lsv2.")]) == {}


def _span_metrics():
    return [m for m in common.benchmark()["per_layer"]
            if m["source"] == "program_span"]


@pytest.mark.parametrize("m", _span_metrics(), ids=lambda m: m["name"])
def test_span_metrics_read(m):
    reader = common.load_module(common.HERE / "metrics" / f"{m['name']}.py")
    value = reader.read({"spans": spans.read_spans(_events()), "calls": 2})
    assert isinstance(value, float) and value >= 0.0
    # A program without spans: nothing to read, and no error.
    assert reader.read({"spans": {}, "calls": 2}) is None
    assert reader.read({"calls": 2}) is None


def test_idle_metrics_partition_the_idle():
    """The serving idle metrics, with the spans no metric names (render
    itself, the training phases), sum to the idle a call."""
    rec = {"spans": spans.read_spans(_events()), "calls": 2}
    read = {m["name"]: common.load_module(
        common.HERE / "metrics" / f"{m['name']}.py").read(rec)
        for m in _span_metrics()}
    rest = sum(rec["spans"][n]["idle_s"] for n in
               ("render", "accept", "backward", "optimizer")) * 1e3 / 2
    total = sum(read[f"serve.{n}_idle_ms"] for n in
                ("preprocess", "binning", "blend", "query", "caller")
                if read.get(f"serve.{n}_idle_ms") is not None)
    assert total + rest == pytest.approx(132 * US * 1e3 / 2)
    assert read["serve.launches"] == 2.0 and read["train.launches"] == 3.0


def test_traced_run_spans_found_through_the_tracer():
    from langsplatv2_tpu_torch import tracing

    tracer = trace.Tracer(0, 0, 2)
    with tracer:
        for _ in range(2):
            with torch.profiler.record_function(trace.CALL), \
                    tracing.span("render"):
                with tracing.span("blend"):
                    torch.ones(64).sum()
            tracer.step()
    tracer.events()                    # run.py reads (and deletes) it first
    got = spans.of({"calls": 2})
    assert set(got) >= {"render", "blend", spans.CALLER}
    assert got["render"]["host_s"] > 0.0 and got["blend"]["host_s"] > 0.0
