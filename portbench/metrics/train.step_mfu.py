"""The whole step's share of the chip's peak, in %: the sum over the
traced steps of every stage's least time (preprocess, top-k codes,
binning, blend, the Gram loss forward and backward, the feature backward,
the pair gradients, Adam) over the traced window's length."""


def read(rec: dict):
    return 100.0 * sum(rec["least_s"].values()) / rec["window_s"]
