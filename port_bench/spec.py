"""What a cell is, read from ``BENCHMARK.json`` and the benchmark's data files.

A cell of ``BENCHMARK.json``'s ``workloads`` names a configuration and a
traffic mix.  The harness finds everything else by those names:

- ``configs/<config>.json`` (the file ``BENCHMARK.json`` gives): the
  program's model and integrator, the plain reference's physics, the
  guarantees, the launch counters to hold;
- ``traffic/<traffic>.json``: members, initial conditions, drift cadence;
- ``workloads/<cell>.json``: the limits of the numbers that decide
  ``correct`` and the length of the traced slice;
- ``cost/<config>.py``: the frozen operations and bytes of a member-step;
- ``metrics/<metric>.py``: one reader per per-layer metric; a metric
  split by cell (``<base>.<part>``) takes ``metrics/<base>.py`` unless it
  has a file of its own.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent

__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_benchmark", "load_cell", "load_module",
           "reader_path"]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """A Python file of the benchmark loaded by its path (metric names hold
    dots, so they are not importable as module names)."""
    spec = importlib.util.spec_from_file_location(f"port_bench_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: its own file, else its base's."""
    own = BENCH_DIR / "metrics" / f"{metric}.py"
    return own if own.is_file() else BENCH_DIR / "metrics" / f"{metric.split('.')[0]}.py"


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its data files read."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    workload: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    cost: ModuleType

    @property
    def members(self) -> int:
        return int(self.traffic["members"])

    @property
    def steps(self) -> int:
        return int(self.config["integrator"]["steps"])

    @property
    def drift_every(self):
        return self.traffic.get("drift_every")

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]


def _for_cell(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, bench: dict = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; raises KeyError for a name
    it does not list."""
    bench = load_benchmark(root) if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it lists {sorted(by_name)}")
    entry = by_name[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(root / config_entry["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    with open(BENCH_DIR / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config_name=entry["config"],
        config=config,
        traffic=traffic,
        workload=workload,
        end_to_end=_for_cell(bench["end_to_end"], name),
        per_layer=_for_cell(bench["per_layer"], name),
        cost=load_module(BENCH_DIR / "cost" / f"{entry['config']}.py"),
    )
