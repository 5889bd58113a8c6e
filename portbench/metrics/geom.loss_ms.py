"""Device milliseconds a geometry step launched in the loss (L1 and SSIM's
window filters): the device time of every operation launched while the
program's "lsv2.loss" span was open, its children's included, summed
over the traced steps, over their count (portbench/spans.py)."""
from portbench import spans


def read(rec: dict):
    return spans.per_call_ms(rec, "loss", "device_s")
