"""Device milliseconds a geometry step launched in the backward (zero_grad,
loss.backward(): the SSIM adjoint, K7, the reduction, autograd through
the preprocess): the device time of every operation launched while the
program's "lsv2.backward" span was open, its children's included, summed
over the traced steps, over their count (portbench/spans.py)."""
from portbench import spans


def read(rec: dict):
    return spans.per_call_ms(rec, "backward", "device_s")
