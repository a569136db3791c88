"""The control: the plain reference put in the program's place, in the
nearest precision below each one the configuration states (bfloat16 for
the float32 state, float32 for the float64 drift sampler), judged by the
same check as the program.  It has to come out not correct; its readings
set the upper end of each limit (``PERF.md``).

    python3 -m port_bench.control --workload <cell> --seeds <a>,<b>,<c>

runs one job a seed at the cell's size and prints its numbers, one JSON
line a seed.  ``--program lower-sampler`` runs the program itself with its
own sampler one precision down (float32), the program's own path and so
the control of the sampler's numbers; ``--program sound`` runs it as
configured, one job a seed in one process, for the lower readings.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
import time

import torch

from port_bench.check import judge, reference_chain
from port_bench.program import JobOutput
from port_bench.reference.serial_chain import StepState, follow
from port_bench.spec import load_cell
from port_bench.traffic import initial_state

__all__ = ["LOWER", "ReferenceSUT", "control_numbers", "program_numbers", "main"]

#: The nearest precision below each stated one.
LOWER = {"float64": "float32", "float32": "bfloat16"}


class ReferenceSUT:
    """The reference stepping a job as the program would, in lower
    precision, its drift sampled at the cell's cadence."""

    def __init__(self, cell, device):
        self.cell = cell
        self.device = torch.device(device)
        integ = cell.config["integrator"]
        self.integ = integ
        self.dtype = getattr(torch, LOWER[integ["dtype"]])
        self.dt = float(torch.tensor(float(integ["dt"]), dtype=getattr(torch, integ["dtype"])))
        self.chain = reference_chain(cell.config, device, self.dtype)
        sampler = cell.config.get("sampler")
        self.h_chain = (reference_chain(cell.config, device,
                                        getattr(torch, LOWER[sampler["dtype"]]))
                        if sampler else None)

    def run_job(self, q0, p0, snap_chunk, steps=None) -> JobOutput:
        integ, spc = self.integ, int(self.integ["steps_per_call"])
        chunk = int(integ["chunk_steps"])
        steps = self.cell.steps if steps is None else steps
        zero = torch.zeros_like(q0, dtype=self.dtype)
        st = StepState(q0.to(self.dtype), p0.to(self.dtype), zero, zero)
        every = self.cell.drift_every if self.h_chain is not None else None
        drift = h0 = scale = None
        if every:
            hd = self.h_chain.dtype
            h0 = self.h_chain.hamiltonian(st.q.to(hd), st.p.to(hd))
            scale = h0.abs().clamp(min=1.0)
            drift = torch.zeros_like(h0)
        snaps = {}
        for k in range(steps // spc):
            st = follow(self.chain, st, self.dt, spc, iters=tuple(integ["iters"]),
                        steps_per_call=spc)
            step = (k + 1) * spc
            if every and step % every == 0:
                hd = self.h_chain.dtype
                d = (self.h_chain.hamiltonian(st.q.to(hd), st.p.to(hd)) - h0).abs() / scale
                drift = torch.maximum(drift, d)
            if step % chunk == 0 and snap_chunk is not None:
                ci = step // chunk - 1
                if ci == snap_chunk - 1:
                    snaps["start"] = st
                elif ci == snap_chunk:
                    snaps["end"] = st
        return JobOutput(st.q.cpu(), st.p.cpu(), None if drift is None else drift.cpu(),
                         snap_chunk, snaps.get("start"), snaps.get("end"))

    def state_of(self, snap: StepState) -> StepState:
        return StepState(*(t.double() for t in snap))

    def expected_counts(self, jobs: int):
        return None


def control_numbers(cell, seed: int, device) -> dict:
    """One control job at the cell's size from ``seed`` (job 0's draw, its
    first chunk kept for the check), judged as the cell."""
    from port_bench.run import Job

    sut = ReferenceSUT(cell, device)
    q0, p0 = initial_state(cell.config, cell.traffic, seed, 0, device,
                           getattr(torch, cell.config["integrator"]["dtype"]))
    t0 = time.perf_counter()
    out = sut.run_job(q0, p0, snap_chunk=0)
    job = Job(0, q0, p0, out, time.perf_counter() - t0)
    numbers, _, notes = judge(cell, sut, [job], [job], None, device)
    return {"workload": cell.name, "seed": seed, "run": "control", "job_s": job.seconds,
            "correct": all(n.ok for n in numbers), "notes": notes,
            "checks": {n.name: {"value": n.value, "limit": n.limit} for n in numbers}}


def program_numbers(cell, seed: int, device, lower_sampler: bool) -> dict:
    """One job of the program at the cell's size from ``seed`` (job 0's
    draw, its first chunk kept), judged as ``cell``: with
    ``lower_sampler``, its drift sampled one precision below the
    configuration's (``drift_dtype``), the program's own lower-precision
    path and so the control of the sampler's numbers; without, a sound run
    (the lower readings, many seeds in one process)."""
    from port_bench.program import ProgramSUT
    from port_bench.run import Job

    run_cell = cell
    if lower_sampler:
        run_cell = dataclasses.replace(cell, config=copy.deepcopy(cell.config))
        run_cell.config["sampler"]["dtype"] = LOWER[cell.config["sampler"]["dtype"]]
    sut = ProgramSUT(run_cell, device)
    sut.build()
    q0, p0 = initial_state(cell.config, cell.traffic, seed, 0, device, sut.dtype)
    sut.reset_counts()
    t0 = time.perf_counter()
    out = sut.run_job(q0, p0, snap_chunk=0)
    job = Job(0, q0, p0, out, time.perf_counter() - t0)
    numbers, _, notes = judge(cell, sut, [job], [job], sut.counts(), device)
    label = ("program, sampler " + run_cell.config["sampler"]["dtype"]) if lower_sampler \
        else "program"
    return {"workload": cell.name, "seed": seed, "run": label, "job_s": job.seconds,
            "correct": all(n.ok for n in numbers), "notes": notes,
            "checks": {n.name: {"value": n.value, "limit": n.limit} for n in numbers}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run the lower-precision control of a cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", choices=("sound", "lower-sampler"),
                    help="one job of the program a seed in place of the reference: as "
                         "configured (lower readings), or with its sampler one precision "
                         "down (the sampler's control)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_bench.control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            row = program_numbers(cell, seed, device, args.program == "lower-sampler")
        else:
            row = control_numbers(cell, seed, device)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
