"""Device milliseconds a frame in the blend (K2, ops/blend.py), from the
"sort" mark to the "blend" mark: the device time of every operation the
host launched in that interval, whatever its name, summed over the
traced frames, over their count."""


def read(rec: dict):
    t = rec["stage_s"].get("blend")
    return None if t is None else 1e3 * t / rec["calls"]
