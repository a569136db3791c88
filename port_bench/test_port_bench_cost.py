"""Each configuration's frozen cost of a member-step equals what the
program's ``fused_step_cost`` counts at the cell's shape today; the numbers
are pinned here too, so a change of either side shows."""

import pytest
import torch

from port_bench.spec import load_benchmark, load_cell

PINNED = {
    "chain20": (3729.4, 61.2, 19.2),
    "double_pendulum": (201.2, 8.12, 1.28),
}

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.mark.parametrize("cell_name", CELLS)
def test_frozen_cost_equals_the_programs_count(cell_name):
    from hamilton_tpu_torch import models
    from hamilton_tpu_torch.utils.roofline import fused_step_cost

    cell = load_cell(cell_name)
    integ = cell.config["integrator"]
    dtype = getattr(torch, integ["dtype"])
    prog = cell.config["program"]
    example = getattr(models, prog["model"])(**prog["kwargs"], device="cpu", dtype=dtype)
    got = fused_step_cost(example.system, method=integ["method"], iters=tuple(integ["iters"]),
                          steps_per_call=integ["steps_per_call"],
                          compensated=integ["compensated"], batch=cell.members, dtype=dtype)
    cost = cell.cost
    assert got["flops_per_member_step"] == pytest.approx(cost.FLOPS_PER_MEMBER_STEP, rel=1e-12)
    assert got["transcendentals_per_member_step"] == pytest.approx(
        cost.TRANSCENDENTALS_PER_MEMBER_STEP, rel=1e-12)
    assert got["bytes_per_member_step"] == pytest.approx(cost.BYTES_PER_MEMBER_STEP, rel=1e-12)
    assert cost.DTYPE == integ["dtype"]
    assert (cost.FLOPS_PER_MEMBER_STEP, cost.TRANSCENDENTALS_PER_MEMBER_STEP,
            cost.BYTES_PER_MEMBER_STEP) == PINNED[cell.config_name]
