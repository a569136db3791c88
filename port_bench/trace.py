"""Reduction of a ``torch.profiler`` slice to what the per-layer readers
need: the device's operations by interval, the benchmark's own host spans
(``port_bench.*``, ``record_function``), and the member-steps the slice's
jobs stepped."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

__all__ = ["TraceSlice", "reduce_profile", "SLICE_SPAN"]

#: The host span around the traced jobs: the slice's bounds.
SLICE_SPAN = "port_bench.slice"

Interval = Tuple[str, float, float]


def _merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def _short(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespace and argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name.strip()[:120]


@dataclass
class TraceSlice:
    """Device operations and host spans in microseconds on the profiler's
    clock, clipped to the slice ``[t0, t1]``."""

    t0: float
    t1: float
    device_ops: List[Interval]
    spans: List[Interval]
    member_steps: int
    _busy: List[Tuple[float, float]] = field(default_factory=list, repr=False)

    def __post_init__(self):
        self._busy = _merged([(s, e) for _, s, e in self.device_ops])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(e - s for s, e in self._busy) / 1e6

    def op_seconds(self, patterns: Sequence[str], invert: bool = False) -> float:
        """Summed device seconds of the kernels whose name holds one of
        ``patterns`` (with ``invert``, of those that hold none); copies and
        fills are left out."""
        total = 0.0
        for name, s, e in self.device_ops:
            if name.startswith(("Memcpy", "Memset")):
                continue
            if any(p in name for p in patterns) != invert:
                total += e - s
        return total / 1e6

    def top_ops(self, k: int = 10) -> List[list]:
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e in self.device_ops:
            by_name[_short(name)] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The device's idle time in the slice, summed by what the host was
        doing: the innermost benchmark span around each gap's midpoint."""
        edges = [self.t0] + [x for iv in self._busy for x in iv] + [self.t1]
        by_name: Dict[str, float] = defaultdict(float)
        for start, end in zip(edges[0::2], edges[1::2]):
            if end <= start:
                continue
            mid = (start + end) / 2
            inside = [(s, n) for n, s, e in self.spans if s <= mid <= e and n != SLICE_SPAN]
            name = max(inside)[1] if inside else "outside the benchmark's spans"
            by_name[name] += (end - start) / 1e6
        return [[n, v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:k]]


def reduce_profile(prof, member_steps: int) -> TraceSlice:
    """The slice of a finished ``torch.profiler.profile``: its device
    events and the benchmark's spans, clipped to the ``SLICE_SPAN``."""
    from torch.autograd import DeviceType

    device_ops, spans = [], []
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.name.startswith("port_bench."):
            # the spans; on the device's timeline too, as annotations
            if e.device_type != DeviceType.CUDA:
                spans.append((e.name, start, end))
        elif e.device_type == DeviceType.CUDA:
            device_ops.append((e.name, start, end))
    bounds = [(s, e) for n, s, e in spans if n == SLICE_SPAN]
    if not bounds:
        raise RuntimeError(f"the profile holds no {SLICE_SPAN} span")
    t0, t1 = bounds[0]
    clipped = [(n, max(s, t0), min(e, t1)) for n, s, e in device_ops if e > t0 and s < t1]
    return TraceSlice(t0, t1, clipped, spans, member_steps)
