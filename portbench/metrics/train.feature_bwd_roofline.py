"""K4's share of its roofline, in %: the least time of the feature
backward's work (roofline.feature_bwd, the reference's pair counts) over
the traced device time of the kernels named below."""

KERNELS = ("feature_bwd_kernel",)


def read(rec: dict):
    t = sum(s for name, s in rec["ops"].items()
            if any(k in name for k in KERNELS))
    return None if not t else 100.0 * rec["least_s"]["feature_bwd"] / t
