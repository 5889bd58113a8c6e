"""Device idle milliseconds a frame begun outside every "lsv2.*" span of
the program: gaps that open while the host is in the entry's own code
(between the program's calls, the copy to the host, the wait on the
oldest frame) or in no call at all, summed over the traced frames, over
their count (portbench/spans.py)."""
from portbench import spans


def read(rec: dict):
    return spans.per_call_ms(rec, spans.CALLER, "idle_s")
