"""K1's share of its roofline in the traced slice: the least time the
slice's member-steps of the step could take (frozen operations and bytes,
``cost/<config>.py``, at the published peaks) over K1's device time."""

from port_bench.record import k1_patterns


def read(run):
    t = run.trace
    if t is None:
        return None
    k1 = t.op_seconds(k1_patterns())
    if k1 <= 0:
        return None
    return 100.0 * run.least_k1_seconds(t.member_steps) / k1
