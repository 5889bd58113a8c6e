"""K7's share of its roofline, in %: the least time of the geometry
backward's per-entry gradients (roofline_geometry.rgb_bwd, the
reference's pair counts) over the traced device time of the kernels named
below."""

KERNELS = ("rgb_bwd_kernel",)


def read(rec: dict):
    t = sum(s for name, s in rec["ops"].items()
            if any(k in name for k in KERNELS))
    return None if not t else 100.0 * rec["least_s"]["rgb_bwd"] / t
