"""The share of the traced window in which no operation ran on the device,
in % (1 - the union of the device's operation intervals over the
window)."""


def read(trace):
    d = trace.device
    return None if d is None else 100.0 * (1 - d["busy_s"] / d["window_s"])
