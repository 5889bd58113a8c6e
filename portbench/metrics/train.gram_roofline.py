"""K6a's and K6b's share of their roofline, in %: the least time of the
Gram loss forward and backward (roofline.gram_fwd, gram_bwd) over the
traced device time of the kernels named below."""

KERNELS = ("gram_kernel",)


def read(rec: dict):
    t = sum(s for name, s in rec["ops"].items()
            if any(k in name for k in KERNELS))
    return None if not t else 100.0 * (rec["least_s"]["gram_fwd"]
                                       + rec["least_s"]["gram_bwd"]) / t
