"""Device milliseconds a step launched in the top-k codes of the logits
(models/gaussians.py get_weights_and_indices, in the forward): the
device time of every operation launched while the program's
"lsv2.topk_codes" span was open, its children's included, summed over
the traced steps, over their count (portbench/spans.py)."""
from portbench import spans


def read(rec: dict):
    return spans.per_call_ms(rec, "topk_codes", "device_s")
