"""The comparison that decides ``correct``.

Both configurations are chaotic over their horizons, so no final state can
be held against a recomputation member by member.  The check holds the
timed path's outputs to the plain reference (``reference/serial_chain.py``,
float64) in four ways:

- ``energy_gap``: every member of every finished job, its final state's
  ``|H − H₀| / max(|H₀|, 1)`` by the reference's Hamiltonian;
- ``drift_max``, ``sampler_gap`` and ``sampler_excess`` (cells that sample
  drift): the largest per-member drift the program's sampler reported,
  against the configuration's guarantee; how far the reference's drift at
  the final state (a sample the program also takes) lies above the
  program's maximum (a sample missed or read low); and the median over the
  members of the program's maximum less that final drift (a sampler in a
  lower precision reads its rounding into every sample, and the maximum
  keeps the largest);
- ``q_gap`` and ``p_gap``: one chunk followed by the reference, from the
  benchmark's own initial state through job 0's first chunk (the start),
  and from the program's own carry through one chunk of a job drawn from
  the seed (at most ``FOLLOW_MEMBERS`` of the members, drawn from the
  seed); the widest gap over those members, each member's ``q`` relative
  to its largest reference angle and ``p`` to the largest reference
  momentum of all (both at least 1: a float32 angle that has wound round
  many times carries its rounding at its own scale, ~3e-5 rad a step at
  700 rad, and the chaos spreads it over the member's other angles);
- ``launches_off``: the launch counters against what the jobs must launch
  (on the card).

Each number has its limit in ``workloads/<cell>.json``; ``PERF.md`` gives
the readings each limit was set from.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from port_bench.reference.serial_chain import SerialChain, StepState, follow

__all__ = ["Number", "reference_chain", "judge", "FOLLOW_MEMBERS"]

#: The most members the reference follows through a chunk, drawn from the
#: seed: at 262144 members the following alone outlasts the window.
FOLLOW_MEMBERS = 65536


@dataclass
class Number:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def reference_chain(config: dict, device, dtype=torch.float64) -> SerialChain:
    ref = config["reference"]
    return SerialChain(ref["masses"], ref["lengths"], ref["gravity"],
                       ref.get("potential_offset", 0.0), dtype=dtype, device=device)


def _finite_max(x: torch.Tensor) -> float:
    return float(x.max()) if bool(torch.isfinite(x).all()) else math.inf


def _energy(chain: SerialChain, jobs, device):
    """The largest relative energy change over every member of every job,
    each member's program's sampled maximum less the reference's final
    drift (empty where the jobs carry none), and each job's largest
    change."""
    worst, excess, per_job = 0.0, [], []
    for job in jobs:
        q0, p0 = job.q0.to(device, torch.float64), job.p0.to(device, torch.float64)
        q1 = job.out.final_q.to(device, torch.float64)
        p1 = job.out.final_p.to(device, torch.float64)
        h0 = chain.hamiltonian(q0, p0)
        rel = (chain.hamiltonian(q1, p1) - h0).abs() / h0.abs().clamp(min=1.0)
        job_worst = _finite_max(rel)
        per_job.append(job_worst)
        worst = max(worst, job_worst)
        if job.out.drift is not None:
            excess.append(job.out.drift.to(device, torch.float64) - rel)
    return worst, torch.cat(excess) if excess else None, per_job


def _follow_gap(chain: SerialChain, start: StepState, end: StepState, config: dict,
                dt: float):
    """``(q_gap, p_gap, wound)``: ``wound`` the widest relative and absolute
    gap of the members with an angle past one turn (printed beside the
    check, not held)."""
    integ = config["integrator"]
    ref = follow(chain, start, dt, integ["chunk_steps"], iters=tuple(integ["iters"]),
                 steps_per_call=integ["steps_per_call"])
    gap = (end.q - ref.q).abs()
    q_scale = ref.q.abs().amax(-1, keepdim=True)
    q_rel = gap / q_scale.clamp(min=1.0)
    turned = (q_scale > 2 * math.pi).expand_as(gap)
    wound = (_finite_max(q_rel[turned]), _finite_max(gap[turned])) if bool(turned.any()) \
        else (0.0, 0.0)
    p_scale = max(float(ref.p.abs().max()), 1.0)
    return _finite_max(q_rel), _finite_max((end.p - ref.p).abs()) / p_scale, wound


def _members(state: StepState, rows: Optional[torch.Tensor]) -> StepState:
    return state if rows is None else StepState(*(t[rows] for t in state))


def judge(cell, sut, jobs, checked, counts: Optional[Dict[str, int]], device,
          seed: int = 0) -> tuple:
    """``(numbers, failed_jobs, notes)``, ``notes`` what the run prints
    beside the check.  ``jobs``: the finished jobs (``q0``,
    ``p0`` the benchmark's initial state, ``out`` the program's
    :class:`~port_bench.program.JobOutput`); ``checked``: the jobs whose
    kept chunk the reference follows; ``counts``: the launch counts over
    the window, or None where nothing launches on the card."""
    chain = reference_chain(cell.config, device)
    limits = cell.limits
    sampled = cell.drift_every is not None
    numbers = []
    energy, excess, per_job = _energy(chain, jobs, device)
    numbers.append(Number("energy_gap", energy, limits["energy_gap"]))
    if sampled:
        drifts = [_finite_max(j.out.drift) if j.out.drift is not None else math.inf
                  for j in jobs]
        numbers.append(Number("drift_max", max(drifts), limits["drift_max"]))
        if excess is None or not bool(torch.isfinite(excess).all()):
            gap = median = math.inf
        else:
            gap, median = float(-excess.min()), float(excess.median())
        numbers.append(Number("sampler_gap", gap, limits["sampler_gap"]))
        numbers.append(Number("sampler_excess", median, limits["sampler_excess"]))
    integ = cell.config["integrator"]
    dt = float(torch.tensor(float(integ["dt"]), dtype=getattr(torch, integ["dtype"])))
    q_gap = p_gap = 0.0
    wound = [0.0, 0.0]
    rows = None
    if cell.members > FOLLOW_MEMBERS:
        gen = torch.Generator().manual_seed(seed % 2**63)
        rows = torch.randperm(cell.members, generator=gen)[:FOLLOW_MEMBERS].to(device)
    for job in checked:
        out = job.out
        if out.snap_end is None:
            q_gap = p_gap = math.inf
            continue
        if out.snap_chunk == 0:
            zero = torch.zeros_like(job.q0, dtype=torch.float64, device=device)
            start = StepState(job.q0.to(device, torch.float64),
                              job.p0.to(device, torch.float64), zero, zero)
        else:
            start = sut.state_of(out.snap_start)
        end = sut.state_of(out.snap_end)
        qg, pg, wg = _follow_gap(chain, _members(start, rows), _members(end, rows),
                                 cell.config, dt)
        q_gap, p_gap = max(q_gap, qg), max(p_gap, pg)
        wound = [max(a, b) for a, b in zip(wound, wg)]
    numbers.append(Number("q_gap", q_gap, limits["q_gap"]))
    numbers.append(Number("p_gap", p_gap, limits["p_gap"]))
    expected = sut.expected_counts(len(jobs))
    if expected is not None:
        off = sum(abs(counts.get(k, 0) - v) for k, v in expected.items()) if counts else math.inf
        numbers.append(Number("launches_off", float(off), 0.0))
    failed = sum(1 for w in per_job if not w <= limits["energy_gap"])
    notes = {"q_gap_past_a_turn": wound[0], "q_gap_past_a_turn_rad": wound[1]}
    return numbers, failed, notes
