"""Host milliseconds a step spends in the trainer's step call (forward,
the guard's read of the live total, backward and Adam's launch): the mean
over the traced run's whole window (host clock)."""


def read(rec: dict):
    return 1e3 * rec["dispatch_s"]
