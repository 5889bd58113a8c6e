"""Device operations a step: those launched inside the program's
"lsv2.step" span (its forward, loss, guard, backward and optimizer), over
the traced steps' count (portbench/spans.py)."""
from portbench import spans


def read(rec: dict):
    s = spans.of(rec)
    return None if s is None or "step" not in s \
        else s["step"]["ops"] / rec["calls"]
