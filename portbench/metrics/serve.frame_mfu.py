"""The whole frame's share of the chip's peak, in %: the sum over the
traced frames of every stage's least time (preprocess, binning, blend,
assemble, query) over the traced window's length."""


def read(rec: dict):
    return 100.0 * sum(rec["least_s"].values()) / rec["window_s"]
