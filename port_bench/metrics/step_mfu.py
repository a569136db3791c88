"""The whole step's share of the card's peak: the frozen operations of the
slice's member-steps over the slice's wall time at the dtype's published
peak.  It bounds K1's roofline share from below whatever kernel runs the
step."""

from port_bench.record import peaks


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    cost = run.cell.cost
    ops = t.member_steps * cost.OPS_PER_MEMBER_STEP
    return 100.0 * ops / (t.window_s * peaks()["flops_per_s"][cost.DTYPE])
