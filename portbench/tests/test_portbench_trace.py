"""The trace's reduction on a hand-made Chrome trace: device operations
go to the call and stage in which the host launched them, an operation
whose launch is missing takes the stage of the one before it on its
stream, the device timeline's copies of the host ranges are not calls,
and the idle gaps go to the innermost host range open at their start."""
from portbench import trace


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def _events():
    ev = [_x("ProfilerStep#4", "user_annotation", 0, 100),
          _x(trace.CALL, "user_annotation", 1, 90),
          _x(trace.CALL, "gpu_user_annotation", 10, 60),
          _x(trace.STAGE + "preprocess", "user_annotation", 20, 0),
          _x(trace.STAGE + "blend", "user_annotation", 40, 0),
          _x("aten::mul", "cpu_op", 2, 10),
          _x("cudaLaunchKernel", "cuda_runtime", 5, 1, correlation=1),
          _x("cudaLaunchKernel", "cuda_runtime", 30, 1, correlation=2)]
    ev += [_x("k_pre", "kernel", 10, 10, correlation=1, stream=7),
           _x("k_mid", "kernel", 25, 5, correlation=2, stream=7),
           _x("k_lib", "kernel", 32, 20, correlation=99, stream=7)]
    return ev


def test_stages_calls_and_idle():
    rec = trace.read(_events())
    assert len(rec["calls"]) == 1 and rec["unmatched"] == 1
    call = rec["calls"][0]
    assert abs(call["preprocess"] - 10e-6) < 1e-12
    # k_mid was launched after the preprocess mark; k_lib has no launch in
    # the trace and follows k_mid on stream 7.
    assert abs(call["blend"] - 25e-6) < 1e-12
    assert abs(rec["busy_s"] - 35e-6) < 1e-12
    assert abs(rec["window_s"] - 100e-6) < 1e-12
    # Gaps at 0 (before any range), then at 20, 30 and 52 inside the call.
    assert abs(rec["gaps"]["(host outside any range)"] - 10e-6) < 1e-12
    assert abs(rec["gaps"][trace.CALL] - 55e-6) < 1e-12
    bd = trace.breakdown(rec)
    assert [n for n, _ in bd["device_ops"]] == ["k_lib", "k_pre", "k_mid"]
