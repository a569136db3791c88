"""Vectorized observables over trajectories and ensembles, and streaming
observables for the ensemble drivers.

PyTorch counterpart of :mod:`hamilton_tpu.utils.observables`: the demo
infobox's KE/PE/H, vectorized (``energies``), the energy-drift statistic
(``energy_drift``), a post-hoc Lyapunov estimate, and the streaming protocol
that ``evolve_ensemble_final``/``evolve_ensemble_chunked`` run inside their
loop with ``observable=`` and ``obs_every=``:

    transforms_state: bool          # class attribute
    init(phase0) -> obs_state       # a dict of tensors
    update(obs_state, phase, step) -> obs_state            (observe-only)
    update(obs_state, phase, step) -> (obs_state, phase')  (transforming)

A transforming observable (Benettin renormalization, :class:`LyapunovPairs`)
returns a replacement :class:`Phase`; the ensemble driver re-inits the
stepper carry from it.  ``step`` is the global dt-step index, a Python int.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from hamilton_tpu_torch.mechanics import ke_p, pe
from hamilton_tpu_torch.state import Phase
from hamilton_tpu_torch.system import System

__all__ = [
    "energies",
    "hamiltonian_trajectory",
    "energy_drift",
    "lyapunov_estimate",
    "RunningExtrema",
    "LyapunovPairs",
    "PoincareSections",
]


def _tiny(dtype) -> float:
    return 1e-300 if dtype == torch.float64 else 1e-37


def energies(system: System, phase: Phase) -> Dict[str, torch.Tensor]:
    """KE, PE and H of an (arbitrarily batched) phase-space state: input axes
    ``(..., n)`` give outputs of shape ``(...)``."""
    ke = ke_p(system, phase)
    pot = pe(system, phase.q)
    return {"ke": ke, "pe": pot, "h": ke + pot}


def hamiltonian_trajectory(system: System, traj: Phase) -> torch.Tensor:
    """``H(t)`` along a trajectory (leading axes time/batch)."""
    return energies(system, traj)["h"]


def energy_drift(system: System, traj: Phase) -> torch.Tensor:
    """``max_t |H(t) − H(0)| / max(|H(0)|, 1)`` per trajectory: ``traj`` has
    axes ``(time, ..., n)``, the result shape ``(...)``."""
    h = hamiltonian_trajectory(system, traj)
    h0 = h[0]
    return torch.amax(torch.abs(h - h0) / torch.clamp(torch.abs(h0), min=1.0), dim=0)


def lyapunov_estimate(system: System, traj_a: Phase, traj_b: Phase,
                      dt_emit: float) -> torch.Tensor:
    """Crude largest-Lyapunov-exponent estimate from a pair of nearby
    trajectories: the least-squares slope of ``log‖Δz(t)‖`` over the emitted
    grid.  Axes ``(time, ..., n)`` → shape ``(...)``."""
    dq = traj_a.q - traj_b.q
    dp = traj_a.p - traj_b.p
    sep = torch.sqrt(torch.sum(dq ** 2 + dp ** 2, dim=-1))
    log_sep = torch.log(torch.clamp(sep, min=_tiny(sep.dtype)))
    t = torch.arange(log_sep.shape[0], dtype=log_sep.dtype, device=log_sep.device) * dt_emit
    tc = (t - torch.mean(t)).reshape((-1,) + (1,) * (log_sep.ndim - 1))
    return torch.sum(tc * (log_sep - torch.mean(log_sep, dim=0)), dim=0) / torch.sum(tc ** 2)


class RunningExtrema:
    """Streaming min/max of a scalar observable ``fn(phase) -> (...)``:
    closest approaches or amplitude envelopes over a whole horizon with no
    emitted trajectory."""

    transforms_state = False

    def __init__(self, fn):
        self.fn = fn

    def init(self, phase0):
        v = self.fn(phase0)
        return {"min": v, "max": v}

    def update(self, state, phase, step):
        v = self.fn(phase)
        return {"min": torch.minimum(state["min"], v), "max": torch.maximum(state["max"], v)}


class LyapunovPairs:
    """Streaming largest-Lyapunov-exponent estimate by Benettin's pair
    method, inside the evolution loop.

    Members are interleaved pairs: member ``2j`` is the fiducial
    trajectory, ``2j+1`` its perturbation at phase-space distance ``d0``
    (:meth:`pair_ensemble` builds them).  Every ``obs_every`` steps the
    separation ``d = ‖(Δq, Δp)‖`` is measured, ``log(d/d0)`` accumulates per
    pair, and the perturbed member is pulled back to distance ``d0`` along
    the current separation (a transforming observable).  λ_max is the
    accumulated log-growth over the elapsed time (:meth:`lyapunov`).
    """

    transforms_state = True

    def __init__(self, d0: float = 1e-5):
        self.d0 = float(d0)

    @staticmethod
    def pair_ensemble(phase0: Phase, d0: float, *,
                      generator: Optional[torch.Generator] = None) -> Phase:
        """Interleave a ``(B, n)`` ensemble with perturbed partners →
        ``(2B, n)``: q displaced by ``d0`` along a fixed unit direction, or a
        random one per member drawn from ``generator``."""
        b, n = phase0.q.shape
        if generator is None:
            direction = torch.ones((b, n), dtype=phase0.q.dtype, device=phase0.q.device)
        else:
            direction = torch.randn((b, n), generator=generator, dtype=phase0.q.dtype,
                                    device=generator.device).to(phase0.q.device)
        direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
        q = torch.stack([phase0.q, phase0.q + d0 * direction], dim=1)
        p = torch.stack([phase0.p, phase0.p], dim=1)
        return Phase(q.reshape(2 * b, n), p.reshape(2 * b, n))

    def _sep(self, phase):
        dq = phase.q[1::2] - phase.q[0::2]
        dp = phase.p[1::2] - phase.p[0::2]
        d2 = torch.sum(dq * dq + dp * dp, dim=-1)
        return torch.sqrt(torch.clamp(d2, min=_tiny(d2.dtype))), dq, dp

    def init(self, phase0):
        if phase0.q.shape[0] % 2:
            raise ValueError("LyapunovPairs needs an even (paired) batch")
        d, _, _ = self._sep(phase0)
        return {"sum_log": torch.zeros_like(d),
                "n_renorms": torch.zeros((), dtype=torch.int32, device=d.device)}

    def update(self, state, phase, step):
        d, dq, dp = self._sep(phase)
        scale = (self.d0 / d)[:, None].to(phase.q.dtype)
        q, p = phase.q.clone(), phase.p.clone()
        q[1::2] = phase.q[0::2] + dq * scale
        p[1::2] = phase.p[0::2] + dp * scale
        new = {"sum_log": state["sum_log"] + torch.log(d / self.d0),
               "n_renorms": state["n_renorms"] + 1}
        return new, Phase(q, p)

    def lyapunov(self, state, total_time: float) -> torch.Tensor:
        """λ_max per pair: the accumulated log-growth over the time span the
        accumulator saw (``n_steps * dt`` when ``obs_every`` divides
        ``n_steps``)."""
        return state["sum_log"] / total_time


class PoincareSections:
    """Streaming Poincaré sections: upward crossings of ``section(phase) ->
    (B,)`` collected inside the evolution loop into ``max_crossings`` slots
    per member, linearly interpolated between the bracketing observations.
    Run with ``obs_every = stepper.substeps`` (every dt-step on the library
    path): crossings are found between consecutive observed states.
    Crossings past ``max_crossings`` count in the per-member ``overflow``."""

    transforms_state = False

    def __init__(self, section, max_crossings: int):
        self.section = section
        self.max_crossings = int(max_crossings)

    def init(self, phase0):
        g = self.section(phase0)
        b = tuple(g.shape)
        n = phase0.q.shape[-1]
        m = self.max_crossings
        zeros = dict(dtype=torch.int32, device=g.device)
        return {
            "prev_g": g,
            "prev_q": phase0.q,
            "prev_p": phase0.p,
            "count": torch.zeros(b, **zeros),
            "overflow": torch.zeros(b, **zeros),
            "q": torch.zeros((m,) + b + (n,), dtype=phase0.q.dtype, device=phase0.q.device),
            "p": torch.zeros((m,) + b + (n,), dtype=phase0.p.dtype, device=phase0.p.device),
        }

    def update(self, state, phase, step):
        g = self.section(phase)
        prev_g = state["prev_g"]
        crossing = (prev_g < 0) & (g >= 0)
        tiny = _tiny(g.dtype)
        denom = torch.where(crossing, prev_g - g, torch.ones_like(g))
        denom = torch.where(torch.abs(denom) < tiny, torch.full_like(denom, tiny), denom)
        frac = torch.where(crossing, prev_g / denom, torch.zeros_like(g))[..., None]
        qx = state["prev_q"] + frac * (phase.q - state["prev_q"])
        px = state["prev_p"] + frac * (phase.p - state["prev_p"])
        m = self.max_crossings
        count = state["count"]
        slot = torch.clamp(count, max=m - 1).long()
        idx = torch.arange(count.shape[0], device=count.device)
        store = crossing & (count < m)
        new_q, new_p = state["q"].clone(), state["p"].clone()
        new_q[slot, idx] = torch.where(store[..., None], qx, state["q"][slot, idx])
        new_p[slot, idx] = torch.where(store[..., None], px, state["p"][slot, idx])
        return {
            "prev_g": g,
            "prev_q": phase.q,
            "prev_p": phase.p,
            "count": count + store.to(torch.int32),
            "overflow": state["overflow"] + (crossing & (count >= m)).to(torch.int32),
            "q": new_q,
            "p": new_p,
        }

    @staticmethod
    def points(state):
        """``(points, valid)``: ``Phase[(max_crossings, B, n)]`` and a boolean
        mask of the filled slots."""
        m = state["q"].shape[0]
        valid = torch.arange(m, device=state["count"].device)[:, None] < state["count"][None, :]
        return Phase(state["q"], state["p"]), valid
