"""Device idle milliseconds a frame put down to the preprocess: the idle gaps
of the traced window that begin while the host is inside the program's
"lsv2.preprocess" span (its innermost "lsv2.*" span), summed over the traced
frames, over their count (portbench/spans.py)."""
from portbench import spans


def read(rec: dict):
    return spans.per_call_ms(rec, "preprocess", "idle_s")
