"""Device idle milliseconds a step begun inside the budget guard: the idle
gaps that open while the host is in the program's "lsv2.accept" span
(the guard reads the live total, so the host waits there on the device),
summed over the traced steps, over their count (portbench/spans.py)."""
from portbench import spans


def read(rec: dict):
    return spans.per_call_ms(rec, "accept", "idle_s")
