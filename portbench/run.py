"""The benchmark of langsplatv2_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json and the files it names under
portbench/ (its configuration, its traffic mix, its cell file), makes the
inputs from the seed on the card, sets the program up, measures for
`--seconds`, checks the sampled outputs against the plain reference and
prints one JSON line (see README.md). With --trace 1 it profiles part of
the window and prints the per-layer metrics instead of the end-to-end
ones. It needs as many CUDA cards as the cell asks for, and exits non-zero
with no result otherwise.
"""
import time

# setup_s counts from here: the interpreter's own start before this line
# (~0.1 s) is left out, since /proc's process start time read seconds off
# on the card's machine.
_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# Every cache the program or torch may build lives in the checkout, at a
# fixed path (the port's kernel library is built into build/ by its own
# code); no library that the port uses may load JAX.
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(REPO / "build" / "portbench" / _sub)
os.environ.update(USE_FLAX="0", USE_TF="0", USE_JAX="0")
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from portbench import common, trace  # noqa: E402
from portbench.reference.precision import no_tf32  # noqa: E402


def power_limit_w(index: int = 0):
    """The card's power limit in W (nvidia-smi), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip())
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def per_layer(bench: dict, workload: str, rec: dict) -> dict:
    """Each per-layer metric of the cell, read by its file
    portbench/metrics/<name>.py; one that finds nothing is left out."""
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        reader = common.load_module(common.HERE / "metrics" / f"{m['name']}.py")
        value = reader.read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float,
             spec_override: dict | None = None) -> tuple:
    """One run; returns (the result line's dict, the checks). The tests
    call it on the CPU at small sizes (`spec_override` merges into the
    configuration, mix and cell files)."""
    bench = common.benchmark()
    w, cfg, mix, spec = common.cell(workload)
    if spec_override:
        cfg = {**cfg, **spec_override.get("config", {})}
        mix = {**mix, **spec_override.get("traffic", {})}
        spec = {**spec, **spec_override.get("cell", {})}
    entry = importlib.import_module(f"portbench.entries.{cfg['entry']}")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    ctx = SimpleNamespace(cfg=cfg, mix=mix, spec=spec, seed=seed,
                          device=device)
    state = entry.setup(ctx)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    tracer = None
    if traced:
        t = spec["trace"]
        tracer = trace.Tracer(t["wait"], t["warmup"], t["active"])
        with tracer:
            res = entry.run(state, seconds=seconds, tracer=tracer)
    else:
        res = entry.run(state, seconds=seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    entry.release(state)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda
                   else "cpu",
                   "count": int(w["chips"]), "memory_peak_bytes": int(peak),
                   "power_limit_w": power_limit_w(device.index or 0)
                   if cuda else None}
    no_tf32()
    result = {"correct": None, "attempted": res["attempted"],
              "failed": res["failed"]}
    if traced:
        rec = trace.read(tracer.events())
        print(f"trace: {rec['device_ops']} device operations, "
              f"{rec['unmatched']} without their launch in the trace",
              file=sys.stderr)
        layer = entry.layer_record(state, res, rec, tracer.traced_calls)
        result["metrics"] = per_layer(bench, workload, layer)
        device_info.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        result["breakdown"] = trace.breakdown(rec)
    else:
        result["metrics"] = {
            name: {"value": float(v), "unit": unit}
            for name, (v, unit) in entry.end_to_end(res).items()}
        result["metrics"]["setup_s"] = {"value": setup_s, "unit": "s"}
    result["device"] = device_info
    nums = entry.outputs_against(state)
    limits = spec["limits"]
    if set(nums) != set(limits):
        raise KeyError(f"the check's numbers {sorted(nums)} and the cell's "
                       f"limits {sorted(limits)} differ")
    checks = {k: {"value": nums[k], "limit": limits[k]} for k in nums}
    result["correct"] = bool(res["failed"] == 0 and all(
        nums[k] <= limits[k] for k in nums))
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    t_start = _T_START
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    w = common.cell(args.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        print(f"portbench: {args.workload} needs {w['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              t_start)
    found = common.forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
