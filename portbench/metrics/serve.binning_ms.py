"""Device milliseconds a frame in the binning (K1, ops/expand.py, and
sort_entries), from the "preprocess" mark to the "sort" mark: the device
time of every operation the host launched in that interval, whatever its
name, summed over the traced frames, over their count."""


def read(rec: dict):
    t = rec["stage_s"].get("binning")
    return None if t is None else 1e3 * t / rec["calls"]
