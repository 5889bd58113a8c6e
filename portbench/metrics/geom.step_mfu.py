"""The whole geometry step's share of the chip's peak, in %: the sum over
the traced steps of every stage's least time (preprocess forward and
backward, binning, blend, loss, K7, the reduction, Adam) and of the
traced rounds' (portbench/roofline_geometry.py) over the traced window's
length."""


def read(rec: dict):
    return 100.0 * sum(rec["least_s"].values()) / rec["window_s"]
