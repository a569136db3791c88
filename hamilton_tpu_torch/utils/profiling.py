"""Timing and profiling on the card (counterpart of
:mod:`hamilton_tpu.utils.profiling`).

:func:`benchmark_fn` times a function on the card between CUDA events: one
first call timed on its own (it may build kernels or warm caches), warm-up
calls, then ``runs`` timed runs whose events are all read after one
synchronize, so the host never waits between runs.  :func:`time_queued`
times calls queued behind a held stream: their device time back to back,
and the host's time to issue one.  :func:`profile_trace`
wraps ``torch.profiler`` for a Chrome trace of the CPU and CUDA activity.
A measurement that finds no card raises: it never falls back to the CPU.

:func:`span` names a range of the program's own work in that trace: the
ensemble drivers open ``hamilton_tpu_torch.ensemble.setup`` once a call
(everything before the first step: the stepper, ``dt``, the drift
sampler's ``H₀``, the initial carry), ``.step`` around each
``stepper.step`` (one K1 launch on the fused stepper) and ``.sample``
around each drift sample.  They are ``torch.profiler`` ranges (one
``RecordFunction`` each, as ``record_function`` opens), on the profiler's
clock beside the device's activity, and live only while a profiler
records: otherwise a span costs one branch on the flag the profiler sets as
it starts and stops.  A live span takes PyTorch's fast entry: through
``record_function`` it costs six times the host time, enough to leave the
card idle between the double pendulum's launches under a profiler.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["BenchResult", "benchmark_fn", "time_queued", "profile_trace", "span",
           "ENSEMBLE_SETUP", "ENSEMBLE_STEP", "ENSEMBLE_SAMPLE"]

#: The ensemble drivers' spans (:mod:`hamilton_tpu_torch.ensemble`).
ENSEMBLE_SETUP = "hamilton_tpu_torch.ensemble.setup"
ENSEMBLE_STEP = "hamilton_tpu_torch.ensemble.step"
ENSEMBLE_SAMPLE = "hamilton_tpu_torch.ensemble.sample"

#: The range a live span opens: a ``RecordFunction`` entered without
#: ``record_function``'s round trip through the dispatcher.
_record = torch._C._profiler._RecordFunctionFast
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler records,
    else a shared no-op context."""
    if _autograd_profiler._is_profiler_enabled:
        return _record(name)
    return _OFF


@dataclass(frozen=True)
class BenchResult:
    """Seconds per call: the first call's wall time (``compile_s``, as the
    reference names it), and the median, mean and minimum of the timed
    runs' device times between CUDA events."""

    compile_s: float
    median_s: float
    mean_s: float
    min_s: float
    runs: int

    def __str__(self) -> str:
        return (
            f"first call {self.compile_s * 1e3:.1f} ms; run median "
            f"{self.median_s * 1e3:.4f} ms / mean {self.mean_s * 1e3:.4f} ms / "
            f"min {self.min_s * 1e3:.4f} ms over {self.runs} runs"
        )


def benchmark_fn(fn: Callable[[], Any], *, warmup: int = 1, runs: int = 5,
                 device=None) -> BenchResult:
    """Time ``fn`` on a CUDA device: the first call alone (wall clock, up to
    a synchronize), ``warmup − 1`` more untimed calls, then ``runs`` calls,
    each between CUDA events."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"benchmark_fn times on a CUDA device, not {device}")
    if runs < 1:
        raise ValueError(f"need runs >= 1, got {runs}")
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    compile_s = time.perf_counter() - t0
    for _ in range(max(warmup - 1, 0)):
        fn()
    events = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize(device)
    times = [s.elapsed_time(e) / 1e3 for s, e in events]
    return BenchResult(
        compile_s=compile_s,
        median_s=statistics.median(times),
        mean_s=sum(times) / len(times),
        min_s=min(times),
        runs=runs,
    )


def time_queued(fn: Callable[[], Any], reps: int) -> Tuple[float, float]:
    """``(device ms, host ms)`` per call of ``fn`` on the current CUDA
    device.  A spin kernel holds the stream while the host issues ``reps``
    calls (host ms is that wall time per call: the cost of issuing one), so
    the events around them then time the calls back to back on the card,
    free of the host's cost.  The spin grows until it outlasts the issue."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_queued times on a CUDA device")
    cycles = 10**8
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) / reps * 1e3
        held = not start.query()  # the card still spins: nothing ran yet
        end.record()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / reps, host
        if cycles >= 10**10:
            raise RuntimeError("the host could not queue the calls ahead of the card")
        cycles *= 4


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block, CPU and CUDA activity, its Chrome
    trace written to ``log_dir/trace.json``; a no-op when ``log_dir`` is
    None.  Yields the profiler (``key_averages()`` for sums by kernel), or
    None."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "trace.json"))
