"""Cells cut to a size the CPU tests can run (a few members, a few hundred
steps), every other setting as ``BENCHMARK.json`` states it."""

from __future__ import annotations

import copy

from port_bench.spec import Cell, load_cell

__all__ = ["tiny_cell"]


def tiny_cell(name: str, members: int = 8, steps: int = 400, chunk: int = 200,
              drift_every: int = 100) -> Cell:
    cell = load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["integrator"].update(steps=steps, chunk_steps=chunk)
    cell.traffic = dict(cell.traffic, members=members)
    if cell.traffic["initial"] == "grid":
        cell.traffic["grid"] = [2, members // 2]
    if cell.traffic.get("drift_every"):
        cell.traffic["drift_every"] = min(drift_every, cell.traffic["drift_every"])
    return cell
