"""The readings that the limits of `correct` are set from, for one cell,
over several seeds in one process:

    python3 portbench/control.py --workload <name> --seeds 1 2 3 --seconds 3

For each seed: the cell's own set-up and a short window at its own load,
then the check's numbers three ways: the program's outputs against the
reference (the lower readings), the reference computed in TF32 in the
program's place (the control: TF32 is the next precision below the f32
that both configurations state), and, for a training cell, the reference
with a planted fault in the program's place (half of each view's pixels
left out, the mean taken over the rest; no update applied). Prints one
JSON line a seed and a summary line: the largest program reading and the
smallest control and fault readings of each number. The benchmark's own
runs never run this.
"""
import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from portbench import common  # noqa: E402
from portbench.reference.precision import no_tf32  # noqa: E402

FAULTS = {"frames": (), "steps": ("half_batch", "unchanged")}


def readings(workload: str, seed: int, seconds: float, device,
             spec_override: dict | None = None) -> dict:
    _w, cfg, mix, spec = common.cell(workload)
    if spec_override:
        cfg = {**cfg, **spec_override.get("config", {})}
        mix = {**mix, **spec_override.get("traffic", {})}
        spec = {**spec, **spec_override.get("cell", {})}
    entry = importlib.import_module(f"portbench.entries.{cfg['entry']}")
    st = entry.setup(SimpleNamespace(cfg=cfg, mix=mix, spec=spec, seed=seed,
                                     device=device))
    res = entry.run(st, seconds=seconds)
    entry.release(st)
    no_tf32()
    out = {"seed": seed, "attempted": res["attempted"],
           "program": entry.outputs_against(st),
           "control": entry.outputs_against(st, prec="tf32")}
    for fault in FAULTS[mix["mode"]]:
        out[fault] = entry.outputs_against(st, fault=fault)
    del st
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(args.workload, seed, args.seconds,
                     torch.device("cuda", 0))
        r["seconds"] = time.perf_counter() - t
        rows.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows),
               "kind": torch.cuda.get_device_name(0)}
    for part in rows[0]:
        if isinstance(rows[0][part], dict):
            pick = max if part == "program" else min
            summary[part] = {k: pick(r[part][k] for r in rows)
                             for k in rows[0][part]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
