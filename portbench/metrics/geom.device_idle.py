"""The share of the traced window, in %, in which no operation ran on the
device (torch.profiler's device activities), over geometry steps."""


def read(rec: dict):
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
