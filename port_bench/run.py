"""Run one cell of the benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up builds or loads the kernel parts the
cell's configuration launches, then runs one short job at the cell's
shapes.  The window then runs back-to-back jobs, each a fresh ensemble drawn
from the seed evolved over the configuration's horizon and read back to the
host, and closes at the first job boundary after ``--seconds``.  Two of
them also keep one chunk's carry for the check.  With ``--trace 1`` whole
jobs after the window run under ``torch.profiler`` and the per-layer
metrics are reported in place of the end-to-end ones.  After the window
the plain reference judges the jobs' outputs (``check.py``).

The last line on standard output is the result, one JSON object; the
numbers that decided ``correct`` end standard error.  Without a CUDA card
(or with fewer than the cell asks for), without the program, or with JAX
or the JAX package loaded once the window has closed, it prints no result
and exits with another code than 0.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from typing import Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import record_function  # noqa: E402

from port_bench.check import judge  # noqa: E402
from port_bench.record import RunRecord  # noqa: E402
from port_bench.spec import load_cell, load_module, reader_path  # noqa: E402
from port_bench.trace import SLICE_SPAN, reduce_profile  # noqa: E402
from port_bench.traffic import initial_state  # noqa: E402

T_IMPORTED = time.perf_counter()

__all__ = ["Job", "run_cell", "main", "FORBIDDEN_MODULES", "forbidden_loaded"]

#: Top-level module names the process must not hold once the window has
#: closed: JAX and the JAX package the program is a port of.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "hamilton_tpu")

#: The job index the warm-up draws its ensemble with (never a window job's).
WARMUP_JOB = -1


@dataclass
class Job:
    index: int
    q0: torch.Tensor
    p0: torch.Tensor
    out: object
    seconds: float


def forbidden_loaded():
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN_MODULES})


def _power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traced_jobs(one_job, seconds: float, device):
    """Whole jobs under ``torch.profiler`` until ``seconds`` have passed:
    each job ends on its read-back, so every traced launch has finished
    when the profiler stops."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(SLICE_SPAN):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                one_job()
    return prof


def run_cell(cell, *, seed: int, seconds: float, trace: bool, device, sut,
             t_start: float) -> dict:
    """One run of ``cell`` on the system under test ``sut`` (its set-up
    timed from ``t_start``); the result object, its ``checks`` last."""
    device = torch.device(device)
    chunk, steps = int(cell.config["integrator"]["chunk_steps"]), cell.steps
    n_chunks = steps // chunk

    # ---- set-up --------------------------------------------------------------
    t_build = time.perf_counter()
    nvcc_runs = sut.build()
    t_warm = time.perf_counter()
    qw, pw = initial_state(cell.config, cell.traffic, seed, WARMUP_JOB, device, sut.dtype)
    sut.run_job(qw, pw, snap_chunk=0, steps=chunk)
    _sync(device)
    readers = {m["name"]: load_module(reader_path(m["name"])) for m in cell.per_layer} \
        if trace else {}
    slice_s = float(cell.workload.get("trace_slice_s", 2.0))
    rng = np.random.default_rng(seed)
    # The check follows job 0's first chunk from the inputs, and one chunk
    # of a later job from the program's own carry: the job drawn from those
    # that job 0's time says the window holds, the chunk drawn from the seed.
    # Only these two jobs synchronize the card at their chunks' ends.
    later_share, later_snap = rng.random(), int(rng.integers(1, max(n_chunks, 2)))
    sut.reset_counts()
    t_window = time.perf_counter()
    setup_parts = {"before_build_s": t_build - t_start, "build_s": t_warm - t_build,
                   "warm_s": t_window - t_warm}
    setup_s = t_window - t_start

    # ---- the window ------------------------------------------------------------
    jobs = []
    later = None

    def one_job(snap=None):
        index = len(jobs)
        t_job = time.perf_counter()
        with record_function("port_bench.job"):
            with record_function("port_bench.initial"):
                q0, p0 = initial_state(cell.config, cell.traffic, seed, index, device,
                                       sut.dtype)
            out = sut.run_job(q0, p0, snap)
        jobs.append(Job(index, q0, p0, out, time.perf_counter() - t_job))

    while time.perf_counter() - t_window < seconds:
        if not jobs:
            one_job(0)
            fits = int(seconds / jobs[0].seconds)
            later = 1 + int(later_share * max(fits - 1, 1))
        else:
            one_job(later_snap if len(jobs) == later else None)
    window_s = time.perf_counter() - t_window
    window_jobs = len(jobs)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # ---- the traced slice: more jobs under the profiler, after the window -----
    traced_slice = None
    if trace:
        prof = _traced_jobs(one_job, slice_s, device)
        traced = len(jobs) - window_jobs
        traced_slice = reduce_profile(prof, traced * cell.members * steps)

    # ---- after the window ----------------------------------------------------
    counts = sut.counts()
    record = RunRecord(cell, traced_slice)
    power_w = _power_limit_w() if device.type == "cuda" else None
    checked = jobs[:1] + [j for j in jobs[1:window_jobs] if j.out.snap_chunk is not None]
    t_check = time.perf_counter()
    numbers, failed, notes = judge(cell, sut, jobs, checked, counts, device, seed)
    _sync(device)
    check_s = time.perf_counter() - t_check

    member_steps = window_jobs * cell.members * steps
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = readers[m["name"]].read(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        # a metric split by cell (``<base>.<part>``) is its base's reading
        e2e = {"member_steps_per_s": member_steps / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(e2e[m["name"].split(".")[0]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": len(jobs) > 0 and all(n.ok for n in numbers),
              "attempted": len(jobs), "failed": failed, "metrics": metrics, "device": dev}
    if trace and traced_slice is not None:
        dev["busy_s"] = traced_slice.busy_s
        dev["window_s"] = traced_slice.window_s
        result["breakdown"] = {"device_ops": traced_slice.top_ops(),
                               "idle_gaps": traced_slice.idle_gaps()}
    result["run"] = {"seed": seed, "window_s": window_s, "jobs": window_jobs,
                     "member_steps": member_steps, "nvcc_runs": nvcc_runs,
                     "power_limit_w": power_w, "traced_jobs": len(jobs) - window_jobs,
                     "checked_jobs": [[j.index, j.out.snap_chunk] for j in checked],
                     "check_s": check_s, "setup_parts": setup_parts, "notes": notes}
    result["checks"] = {n.name: {"value": n.value if math.isfinite(n.value) else str(n.value),
                                 "limit": n.limit} for n in numbers}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("port_bench: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        from port_bench.program import ProgramSUT

        sut = ProgramSUT(cell, device)
    except ImportError as exc:
        print(f"port_bench: the program does not import here: {exc}", file=sys.stderr)
        return 2
    result = run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=device, sut=sut, t_start=T_PROCESS)
    result["run"]["setup_parts"]["imports_s"] = T_IMPORTED - T_PROCESS
    found = forbidden_loaded()
    if found:
        print(f"port_bench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
