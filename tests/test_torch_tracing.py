"""The ensemble drivers' spans (``hamilton_tpu_torch/utils/profiling.py``
``span``): under ``torch.profiler`` each driver records one ``setup`` span
a call (a shard), one ``step`` span a loop iteration and one ``sample``
span a drift sample; with no profiler recording no range is entered; and
the results are bitwise the same either way."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import parallel
from hamilton_tpu_torch.utils import profiling

B, N, STEPS, SPC, DRIFT_EVERY, CHUNK = 8, 3, 24, 2, 4, 8
RUN = dict(method="leapfrog_fused", iters=(2, 0), compensated=True, drift_every=DRIFT_EVERY,
           steps_per_call=SPC, drift_dtype=torch.float64)
NAMES = (profiling.ENSEMBLE_SETUP, profiling.ENSEMBLE_STEP, profiling.ENSEMBLE_SAMPLE)


def _inputs():
    g = torch.Generator().manual_seed(3)
    q = 0.5 + 0.01 * torch.randn(B, N, generator=g)
    p = 0.05 * torch.randn(B, N, generator=g)
    return tp.Phase(q, p)


def _system():
    return tp.chain(n_links=N, fused_solver="semiseparable", device="cpu",
                    dtype=torch.float32).system


def _final():
    return tp.evolve_ensemble_final(_system(), _inputs(), 1e-3, STEPS, **RUN)


def _chunked():
    return tp.evolve_ensemble_chunked(_system(), _inputs(), 1e-3, STEPS, chunk_steps=CHUNK,
                                      **RUN)


def _sharded():
    mesh = parallel.ensemble_mesh(["cpu"] * 2)
    return tp.evolve_ensemble_sharded(_system(), _inputs(), 1e-3, STEPS, mesh=mesh, **RUN)


DRIVERS = {"final": (_final, 1), "chunked": (_chunked, 1), "sharded": (_sharded, 2)}


def _profiled(run):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    counts = collections.Counter(e.name for e in prof.events() if e.name in NAMES)
    return out, counts


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_spans_counted_per_call_iteration_and_sample(driver):
    run, calls = DRIVERS[driver]
    _, counts = _profiled(run)
    assert counts == {profiling.ENSEMBLE_SETUP: calls,
                      profiling.ENSEMBLE_STEP: calls * STEPS // SPC,
                      profiling.ENSEMBLE_SAMPLE: calls * STEPS // DRIFT_EVERY}


def test_no_range_entered_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"range {name!r} entered with no profiler recording")

    monkeypatch.setattr(profiling, "_record", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    for run, _ in DRIVERS.values():
        run()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="entered"):
            _final()


def test_results_bitwise_the_same_with_the_profiler_on_and_off():
    for run, _ in DRIVERS.values():
        off_final, off_drift = run()
        (on_final, on_drift), _ = _profiled(run)
        assert torch.equal(off_final.q, on_final.q) and torch.equal(off_final.p, on_final.p)
        assert torch.equal(off_drift, on_drift) and float(off_drift.max()) > 0
