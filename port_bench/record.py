"""What a run hands the per-layer readers (``metrics/<name>.py``).

A reader is a module with ``read(run) -> float | None``: None where it
finds nothing to read, and the harness then leaves the metric out."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

from port_bench.spec import BENCH_DIR, Cell
from port_bench.trace import TraceSlice

__all__ = ["RunRecord", "peaks", "k1_patterns"]


def peaks() -> dict:
    with open(BENCH_DIR / "peaks.json") as f:
        return json.load(f)


def k1_patterns() -> List[str]:
    with open(BENCH_DIR / "k1_kernels.json") as f:
        return json.load(f)["patterns"]


@dataclass
class RunRecord:
    cell: Cell
    trace: Optional[TraceSlice]

    def least_k1_seconds(self, member_steps: int) -> float:
        """The least time the card could take for ``member_steps`` of the
        configuration's step: frozen operations at the dtype's peak or
        frozen bytes at the memory's, whichever is longer."""
        cost, pk = self.cell.cost, peaks()
        return max(member_steps * cost.OPS_PER_MEMBER_STEP / pk["flops_per_s"][cost.DTYPE],
                   member_steps * cost.BYTES_PER_MEMBER_STEP / pk["bytes_per_s"])
