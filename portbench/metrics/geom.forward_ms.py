"""Device milliseconds a geometry step launched in the forward (the render:
preprocess under autograd, binning, K2): the device time of every
operation launched while the program's "lsv2.forward" span was open, its
children's included, summed over the traced steps, over their count
(portbench/spans.py)."""
from portbench import spans


def read(rec: dict):
    return spans.per_call_ms(rec, "forward", "device_s")
