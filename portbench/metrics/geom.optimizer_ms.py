"""Device milliseconds a geometry step launched in the optimizer (the dead-
row mask, the scheduled rates, Adam over the six groups): the device
time of every operation launched while the program's "lsv2.optimizer"
span was open, its children's included, summed over the traced steps,
over their count (portbench/spans.py)."""
from portbench import spans


def read(rec: dict):
    return spans.per_call_ms(rec, "optimizer", "device_s")
