"""The device's idle share of the traced window: the time in which no
kernel, copy or set ran, in %."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
