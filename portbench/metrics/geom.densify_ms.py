"""Device milliseconds a densification round launched (run_densify: the
round, any capacity growth, the optimizer's row surgery): the device time
of every operation launched while the program's "lsv2.densify" span was
open, over the rounds of the traced steps (the record's `rounds`); 0 when
the program has spans but the traced steps opened no round
(portbench/spans.py)."""
from portbench import spans


def read(rec: dict):
    s = spans.of(rec)
    if s is None:
        return None
    if "densify" not in s:
        return 0.0
    return 1e3 * s["densify"]["device_s"] / max(rec.get("rounds", 1), 1)
