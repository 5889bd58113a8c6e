"""Device milliseconds a frame in the preprocess (ops/projection.py), from
the frame's start to its "preprocess" mark: the device time of every
operation the host launched in that interval, whatever its name, summed
over the traced frames, over their count."""


def read(rec: dict):
    t = rec["stage_s"].get("preprocess")
    return None if t is None else 1e3 * t / rec["calls"]
