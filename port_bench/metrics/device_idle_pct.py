"""The device's idle share of the traced slice: 100 minus the union of its
operations' intervals over the slice's wall time."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
