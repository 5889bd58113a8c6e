"""Device milliseconds a step launched in the backward (loss.backward():
K6b, K4, the pair gradients, the top-k backward): the device time of
every operation launched while the program's "lsv2.backward" span was
open, its children's included, summed over the traced steps, over their
count (portbench/spans.py)."""
from portbench import spans


def read(rec: dict):
    return spans.per_call_ms(rec, "backward", "device_s")
