"""Poincaré section extraction from trajectories.

PyTorch counterpart of :mod:`hamilton_tpu.utils.poincare`: find the
crossings of a trajectory through a section plane ``g(q, p) = 0`` (by
default a coordinate plane ``q[k] = c`` with positive velocity), with linear
interpolation between emitted states.  Vectorized over ensembles; crossing
counts are static-shaped (capped), so the output's shape never depends on
the data.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from hamilton_tpu_torch.state import Phase

__all__ = ["poincare_section", "coordinate_section"]


def coordinate_section(k: int, value: float = 0.0, direction: int = +1):
    """Section function for the plane ``q[k] = value`` crossed with sign
    ``direction`` (+1: increasing)."""

    def g(ph: Phase) -> torch.Tensor:
        s = ph.q[..., k] - value
        return s if direction >= 0 else -s

    return g


def poincare_section(
    traj: Phase,
    section: Callable[[Phase], torch.Tensor],
    *,
    max_crossings: int,
) -> Tuple[Phase, torch.Tensor]:
    """Extract up to ``max_crossings`` upward crossings of ``section`` from a
    trajectory with axes ``(time, ..., n)``.

    Returns ``(points, valid)`` where ``points`` is a :class:`Phase` with
    axes ``(max_crossings, ..., n)`` (linearly interpolated states at the
    crossings; unused slots hold zeros) and ``valid`` is a boolean mask of
    shape ``(max_crossings, ...)``.

    **Truncation contract:** ``max_crossings`` is a static cap (jit needs a
    static output shape), and crossings beyond it are SILENTLY DROPPED —
    the first ``max_crossings`` upward crossings are kept, later ones
    discarded per member.  A dense section is therefore truncated, not
    subsampled.  Detect it: a member whose mask is all-True
    (``valid.all(axis=0)``) may have overflowed — re-run with a larger cap
    (or shorter trajectory window) until its last slots stay False.  Size
    the cap generously: unused slots cost one zeroed state each, far
    cheaper than a re-run.
    """
    g = section(traj)  # (time, ...)
    before, after = g[:-1], g[1:]
    crossing = torch.logical_and(before < 0, after >= 0)  # (time-1, ...)
    # fractional position of the zero within the interval (the 1e-300 is 0
    # in float32, as in the reference)
    frac = torch.where(crossing, before / (before - after + 1e-300), 0.0)

    q0, q1 = traj.q[:-1], traj.q[1:]
    p0, p1 = traj.p[:-1], traj.p[1:]
    qx = q0 + frac[..., None] * (q1 - q0)
    px = p0 + frac[..., None] * (p1 - p0)

    # compact the first max_crossings crossings per member into static slots:
    # slot index = cumulative crossing count - 1; non-crossings and overflow
    # parked in slot max_crossings, which is dropped (the only slot that
    # takes duplicate indices, so the scatter's order never shows)
    order = torch.cumsum(crossing.to(torch.int64), dim=0) - 1  # (time-1, ...)
    slot = torch.where(crossing, order, max_crossings).clamp(max=max_crossings)

    batch_shape = tuple(crossing.shape[1:])
    n = traj.q.shape[-1]
    out_q = traj.q.new_zeros((max_crossings + 1,) + batch_shape + (n,))
    out_p = torch.zeros_like(out_q)
    out_v = torch.zeros((max_crossings + 1,) + batch_shape, dtype=torch.bool,
                        device=crossing.device)

    # scatter each interval's interpolated state into its crossing slot along
    # the time axis; the batch axes are scatter's own
    index = slot[..., None].expand(qx.shape)
    keep = crossing[..., None]
    out_q.scatter_(0, index, torch.where(keep, qx, 0.0))
    out_p.scatter_(0, index, torch.where(keep, px, 0.0))
    out_v.scatter_(0, slot, crossing)

    points = Phase(out_q[:max_crossings], out_p[:max_crossings])
    return points, out_v[:max_crossings]
