"""Host milliseconds a frame spends in the entry's calls (render,
relevancy_from_tiles and the copy's launch), before any wait: the mean
over the traced run's whole window (host clock)."""


def read(rec: dict):
    return 1e3 * rec["dispatch_s"]
