"""The drift sampler's share of the device's busy time in the traced
slice: every kernel but K1's (``k1_kernels.json``) over the union of the
device's operations."""

from port_bench.record import k1_patterns


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    other = t.op_seconds(k1_patterns(), invert=True)
    return 100.0 * other / t.busy_s if other > 0 else None
