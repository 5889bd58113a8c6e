"""The blend's share of its roofline, in %: the least time of the work
these poses need (roofline.blend: the reference's pair counts) over the
device time of the blend interval's operations."""


def read(rec: dict):
    t = rec["stage_s"].get("blend")
    return None if not t else 100.0 * rec["least_s"]["blend"] / t
