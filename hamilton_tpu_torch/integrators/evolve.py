"""Simulation drivers: the public ``stepHam``/``evolveHam`` API surface.

PyTorch counterpart of :mod:`hamilton_tpu.integrators.evolve`:

* :func:`evolve_ham` — adaptive evolution to a vector of output times, GSL
  RKF45 semantics by default (``evolveHam``, ``Numeric/Hamilton.hs:433-462``);
* :func:`evolve_ham_list` — list-in/list-out convenience incl. the
  singleton-times ``[x] -> [0, x]`` quirk (``evolveHam'``, ``:409-429``);
* :func:`step_ham` — single-timestep convenience (``stepHam``, ``:389-402``;
  like the reference it runs the full adaptive solve over ``[0, dt]`` with
  initial step ``dt/100``) and :func:`iterate_ham`, its stream;
* :func:`step_ham_c` / :func:`evolve_ham_c` / :func:`evolve_ham_c_list` —
  configuration-space wrappers (``:470-515``); the simulation itself always
  runs in phase space.

The reference's ``evolve_ham_fixed`` is not ported yet (ROADMAP M11: its
default method, ``gauss4``, is not ported).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from hamilton_tpu_torch.integrators.adaptive import GSL_EPS_DEFAULT, gsl_evolve_to
from hamilton_tpu_torch.mechanics import from_phase, ham_rhs, to_phase
from hamilton_tpu_torch.state import Config, Phase
from hamilton_tpu_torch.system import System

__all__ = [
    "step_ham",
    "iterate_ham",
    "evolve_ham",
    "evolve_ham_list",
    "step_ham_c",
    "evolve_ham_c",
    "evolve_ham_c_list",
]


def _times(ts, like: torch.Tensor) -> torch.Tensor:
    """Times as a tensor in ``like``'s dtype and on its device; Python or
    numpy values are read in float64 first, so ``0.1`` is not rounded to
    float32 on the way."""
    if not isinstance(ts, torch.Tensor):
        ts = torch.as_tensor(ts, dtype=torch.float64)
    return ts.to(dtype=like.dtype, device=like.device)


def evolve_ham(
    system: System,
    phase0: Phase,
    ts,
    *,
    eps_abs: float = GSL_EPS_DEFAULT,
    eps_rel: float = GSL_EPS_DEFAULT,
    h0: Optional[float] = None,
    method: str = "rkf45",
    batch_mode: str = "shared",
    return_stats: bool = False,
):
    """Evolve through phase space, emitting the state at each time in ``ts``.

    The output has leading axis ``len(ts)`` with ``out[0] == phase0``, the
    default initial step is ``(ts[1]-ts[0])/100`` and the default tolerances
    are GSL's ``1.49012e-08``.  ``len(ts) >= 2`` is required, mirroring the
    reference's ``2 <= s`` constraint; use :func:`evolve_ham_list` for looser
    semantics.  The suggested step size carries across output intervals as
    GSL's driver does.

    ``batch_mode`` selects the step controller for *batched* states:

    * ``"shared"`` (default) — one controller for the whole batch, with the
      error norm maximized over all members: every member takes identical
      steps (lock-step);
    * ``"per_member"`` — each member carries its own controller:
      step-for-step equivalent to independent single runs.  The RHS is
      evaluated on the whole batch until the slowest member finishes its
      interval; finished members keep their state.

    ``return_stats=True`` returns ``(trajectory, stats)`` with aggregate
    controller diagnostics: ``saturated`` — True if any interval (of any
    member) exhausted the controller's ``max_steps`` progress guard;
    ``max_interval_steps`` / ``total_failed`` attempt counters.
    """
    y0 = phase0.flatten()
    ts = _times(ts, y0)
    if ts.ndim != 1 or ts.shape[0] < 2:
        raise ValueError(
            f"evolve_ham requires at least 2 output times (got shape "
            f"{tuple(ts.shape)}); this mirrors the reference's `2 <= s` "
            f"constraint (Hamilton.hs:435)"
        )
    if batch_mode not in ("shared", "per_member"):
        raise ValueError(f"unknown {batch_mode=}; use 'shared' or 'per_member'")
    h = (ts[1] - ts[0]) / 100.0 if h0 is None else _times(h0, y0)
    per_member = batch_mode == "per_member" and y0.ndim > 1
    rhs = ham_rhs(system)

    y, ys, sts = y0, [y0], []
    for i in range(ts.shape[0] - 1):
        y, h, st = gsl_evolve_to(
            rhs, y, ts[i], ts[i + 1], h, eps_abs=eps_abs, eps_rel=eps_rel,
            method=method, return_stats=True, per_member=per_member,
        )
        ys.append(y)
        sts.append(st)
    out = Phase.unflatten(torch.stack(ys))
    if not return_stats:
        return out
    # aggregate over the intervals and any per-member controllers
    stats = {
        "saturated": torch.stack([s["saturated"].any() for s in sts]).any(),
        "max_interval_steps": torch.stack([s["n_steps"].max() for s in sts]).max(),
        "total_failed": torch.stack([s["n_failed"].sum() for s in sts]).sum(),
    }
    return out, stats


def evolve_ham_list(
    system: System,
    phase0: Phase,
    ts: Sequence[float],
    **kwargs,
):
    """List-based evolution with the reference's quirk semantics
    (``evolveHam'``): an empty time list returns ``[]``; a singleton ``[x]``
    is padded to ``[0, x]`` and only the state at ``x`` is returned;
    otherwise identical to :func:`evolve_ham`.  Returns a Python list of
    :class:`Phase` (and the stats when ``return_stats=True``)."""
    ts = list(ts)
    if not ts:
        return []
    singleton = len(ts) == 1
    ts_eff = [0.0, ts[0]] if singleton else ts
    out = evolve_ham(system, phase0, ts_eff, **kwargs)
    stats = None
    if kwargs.get("return_stats"):
        out, stats = out
    phases = [Phase(out.q[i], out.p[i]) for i in range(len(ts_eff))]
    phases = phases[1:] if singleton else phases
    return (phases, stats) if stats is not None else phases


def step_ham(system: System, phase0: Phase, dt: float, **kwargs):
    """Advance one timestep ``dt`` through phase space (``stepHam``): the
    full adaptive solve over ``[0, dt]`` (initial step ``dt/100``), returning
    the endpoint.  Argument order is pythonized — the reference's is
    ``stepHam dt system phase``."""
    out = evolve_ham(system, phase0, [0.0, dt], **kwargs)
    if kwargs.get("return_stats"):
        out, stats = out
        return Phase(out.q[1], out.p[1]), stats
    return Phase(out.q[1], out.p[1])


def iterate_ham(system: System, phase0: Phase, dt: float, **kwargs):
    """Infinite stream of states every ``dt``, starting with ``phase0`` (the
    reference README's ``iterate (stepHam 0.1 doublePendulum) phase0``), as a
    Python generator: each element is one :func:`step_ham` from the last."""
    ph = phase0
    while True:
        yield ph
        ph = step_ham(system, ph, dt, **kwargs)


# ----------------------------------------------------------------------
# Configuration-space wrappers (reference Hamilton.hs:470-515)
# ----------------------------------------------------------------------


def step_ham_c(system: System, config0: Config, dt: float, **kwargs):
    """``fromPhase ∘ stepHam ∘ toPhase`` (reference ``stepHamC``)."""
    out = step_ham(system, to_phase(system, config0), dt, **kwargs)
    if kwargs.get("return_stats"):
        ph, stats = out
        return from_phase(system, ph), stats
    return from_phase(system, out)


def evolve_ham_c(system: System, config0: Config, ts, **kwargs):
    """Configuration-space ``evolveHam`` (reference ``evolveHamC``): a
    :class:`Config` with a leading time axis."""
    out = evolve_ham(system, to_phase(system, config0), ts, **kwargs)
    if kwargs.get("return_stats"):
        out, stats = out
        return from_phase(system, out), stats
    return from_phase(system, out)  # batch-aware over the leading time axis


def evolve_ham_c_list(
    system: System, config0: Config, ts: Sequence[float], **kwargs
) -> List[Config]:
    """Configuration-space ``evolveHam'`` (reference ``evolveHamC'``)."""
    out = evolve_ham_list(system, to_phase(system, config0), ts, **kwargs)
    if kwargs.get("return_stats") and isinstance(out, tuple):
        phases, stats = out
        return [from_phase(system, ph) for ph in phases], stats
    return [from_phase(system, ph) for ph in out]
