"""Device milliseconds a step launched in the loss (K6a and the loss's
reductions): the device time of every operation launched while the
program's "lsv2.loss" span was open, its children's included, summed
over the traced steps, over their count (portbench/spans.py)."""
from portbench import spans


def read(rec: dict):
    return spans.per_call_ms(rec, "loss", "device_s")
