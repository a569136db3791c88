"""The trace reduction (``trace.py``) on synthetic profiler events: the
program's own host ranges (``hamilton_tpu_torch.ensemble.*``, opened only
while a profiler records) leave every reading of the slice as it was.  The
program opens them through PyTorch's fast ``RecordFunction``, which puts no
copy of them on the device's timeline."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from port_bench.record import RunRecord
from port_bench.spec import load_benchmark, load_cell, load_module, reader_path
from port_bench.trace import SLICE_SPAN, reduce_profile

SETUP, STEP, SAMPLE = (f"hamilton_tpu_torch.ensemble.{s}" for s in ("setup", "step", "sample"))
K1 = "void fused_step_kernel<float, 20>(float*, int)"
K2A = "void solve_tile_kernel<double, 8>(double const*, double*, int)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4>(int, float*)"

# One job on the profiler's clock (microseconds): the slice and the job
# [0, 100], evolve [5, 90], read-back [90, 100]; inside evolve the
# program's setup [5, 15], step [15, 20], sample [20, 30], step [30, 35].
BENCH_SPANS = [(SLICE_SPAN, 0, 100), ("port_bench.job", 0, 100),
               ("port_bench.evolve", 5, 90), ("port_bench.readback", 90, 100)]
PROGRAM_SPANS = [(SETUP, 5, 15), (STEP, 15, 20), (SAMPLE, 20, 30), (STEP, 30, 35)]
KERNELS = [(ELEMENTWISE, 12, 14), (K1, 18, 40), (K2A, 40, 45), (ELEMENTWISE, 45, 47),
           (K1, 50, 80), ("Memcpy DtoH (Device -> Pageable)", 92, 95)]


def _event(name, start, end, device=DeviceType.CPU):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=device, id=0)


def _slice(program_spans):
    events = [_event(n, s, e) for n, s, e in BENCH_SPANS]
    events += [_event(n, s, e, DeviceType.CUDA) for n, s, e in BENCH_SPANS[1:]]
    if program_spans:
        events += [_event(n, s, e) for n, s, e in PROGRAM_SPANS]
    events += [_event(n, s, e, DeviceType.CUDA) for n, s, e in KERNELS]
    return reduce_profile(SimpleNamespace(events=lambda: events), member_steps=16384 * 100)


METRICS = [(m["name"], cell) for m in load_benchmark()["per_layer"] for cell in m["workloads"]]


@pytest.mark.parametrize("metric,cell", METRICS)
def test_readers_read_the_same_with_and_without_program_spans(metric, cell):
    read = load_module(reader_path(metric)).read
    cell = load_cell(cell)
    with_spans, without = _slice(True), _slice(False)
    value = read(RunRecord(cell, with_spans))
    assert value is not None and value == read(RunRecord(cell, without))


def test_breakdown_the_same_with_and_without_program_spans():
    with_spans, without = _slice(True), _slice(False)
    assert with_spans.device_ops == without.device_ops == [
        (n, float(s), float(e)) for n, s, e in KERNELS]
    assert with_spans.busy_s == without.busy_s == pytest.approx(64e-6)
    assert with_spans.top_ops() == without.top_ops()
    assert with_spans.idle_gaps() == without.idle_gaps()
