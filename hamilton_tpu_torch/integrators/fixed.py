"""Fixed-step integrators (counterpart of :mod:`hamilton_tpu.integrators.fixed`).

Ported so far: the generalized Störmer-Verlet leapfrog (``leapfrog``, the
library path and the fused path's correctness reference), its fused
whole-step form (``leapfrog_fused``, :mod:`hamilton_tpu_torch.ops.fused_step`)
and the fused order-4 compositions of it (``yoshida4_fused``, the triple
jump, and ``suzuki4_fused``, Suzuki's five stages).  The other methods of the
reference (``rk4``, ``midpoint``/``gauss4``/``gauss6``, ``yoshida4``,
``tao2``/``tao4``) are ROADMAP M11.

The Hamiltonian is non-separable, ``H = ½ pᵀK(q)⁻¹p + U(q)``, so the leapfrog
is the semi-implicit two-half-step scheme (Hairer et al., *Geometric
Numerical Integration*, VI.3) solved by a static number of fixed-point
iterations: order 2, symmetric, symplectic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from hamilton_tpu_torch.mechanics import (
    dhdp_factored,
    dhdq_factored,
    q_factor,
    velocities,
)
from hamilton_tpu_torch.state import Phase
from hamilton_tpu_torch.system import System

__all__ = ["Stepper", "make_stepper", "FIXED_METHODS"]


@dataclass(frozen=True)
class Stepper:
    """A fixed-step integrator as an ``(init, step, extract)`` triple.

    ``init`` maps a :class:`Phase` to the integrator's carry, ``step``
    advances the carry by ``dt`` (``substeps`` dt-steps per call for the
    fused multi-step kernel; evolution drivers divide their loop counts by
    it), and ``extract`` projects the carry back to a :class:`Phase`.
    """

    init: Callable[[Phase], Any]
    step: Callable[[Any, Any], Any]
    extract: Callable[[Any], Phase]
    order: int
    symplectic: bool
    substeps: int = 1


def _kahan_add(x, c, d):
    """Compensated accumulation: add increment ``d`` to ``(x, c)`` where ``c``
    carries the running rounding residual.  PyTorch does not reassociate
    floating point, so the cancellation pattern survives; the accumulation
    error stays O(eps) instead of random-walking as O(√N·eps·|y|)."""
    y = d + c
    t = x + y
    c_new = y - (t - x)
    return t, c_new


def _iters_pair(iters):
    iters_p, iters_q = iters if isinstance(iters, tuple) else (iters, iters)
    if iters_p < 1:
        raise ValueError(f"leapfrog needs iters_p >= 1, got {iters_p}")
    if iters_q < 0:
        raise ValueError(
            f"iters_q must be >= 0 (0 selects the Gauss-Seidel predictor-"
            f"factor mode), got {iters_q}"
        )
    return int(iters_p), int(iters_q)


def _leapfrog_stepper(system: System, iters, compensated: bool = False) -> Stepper:
    """Generalized Störmer-Verlet with factor caching: the p½ fixed point
    holds q = q₀, so Cholesky(K) and ∇U are factorized once (``QFactor``)
    and each iteration costs a pair of triangular solves plus one VJP sweep.
    The end-of-step factor at q₁ is the next step's q₀ factor, so the carry
    is ``(Phase, QFactor, warm)`` (plus the Kahan residuals when
    ``compensated``).

    ``iters=(iters_p, iters_q)`` splits the momentum- and position-loop
    counts; ``iters_q=0`` selects the Gauss-Seidel mode (one factorization
    at the warm predictor serves the q-update and the end-of-step force)."""
    iters_p, iters_q = _iters_pair(iters)

    def increments(ph: Phase, fac0, warm, dt):
        """One step in increment form: ``(Δq, Δp, fac1, warm')``.

        ``warm = (a_est, vdot_est)`` warm-starts both fixed points from the
        previous step's converged force and velocity derivative (zeros are
        the cold start); the fixed points are unchanged, only the residual
        after the static iteration counts shrinks."""
        q0, p0 = ph.q, ph.p
        a_est, vdot_est = warm
        half = dt / 2
        # p½ = p0 − h/2 · A,  A = H_q(q0, p½)   (implicit; cached factor)
        ph_half = p0 - half * a_est
        a_last = a_est
        for _ in range(iters_p):
            a_last = dhdq_factored(system, fac0, q0, ph_half)
            ph_half = p0 - half * a_last
        # q1 = q0 + h/2 · (v0 + v1),  v = H_p   (implicit in q1)
        v0 = dhdp_factored(fac0, ph_half)
        v_last = v0
        q1 = q0 + dt * v0 + (dt * half) * vdot_est
        for _ in range(iters_q):
            v_last = velocities(system, Phase(q1, ph_half))
            q1 = q0 + half * (v0 + v_last)
        fac1 = q_factor(system, q1)
        if iters_q == 0:
            # Gauss-Seidel mode: the factor at the O(dt³)-accurate predictor
            # gives the q-update; every consumer sees the same stale factor
            v_last = dhdp_factored(fac1, ph_half)
            q1 = q0 + half * (v0 + v_last)
        dq_inc = half * (v0 + v_last)
        # p1 = p½ − h/2 · B,  B = H_q(q1, p½); the q1 factor carries over
        b_term = dhdq_factored(system, fac1, q1, ph_half)
        dp_inc = -half * (a_last + b_term)
        warm1 = (b_term, (v_last - v0) / dt)
        return dq_inc, dp_inc, fac1, warm1

    def warm0(ph: Phase):
        return (torch.zeros_like(ph.p), torch.zeros_like(ph.q))

    if not compensated:

        def init(ph: Phase):
            return (ph, q_factor(system, ph.q), warm0(ph))

        def step(carry, dt):
            ph, fac0, warm = carry
            dq_inc, dp_inc, fac1, warm1 = increments(ph, fac0, warm, dt)
            return (Phase(ph.q + dq_inc, ph.p + dp_inc), fac1, warm1)

        return Stepper(init, step, lambda c: c[0], order=2, symplectic=True)

    def comp_init(ph: Phase):
        return (ph, q_factor(system, ph.q), warm0(ph),
                Phase(torch.zeros_like(ph.q), torch.zeros_like(ph.p)))

    def comp_step(carry, dt):
        ph, fac0, warm, c = carry
        dq_inc, dp_inc, fac1, warm1 = increments(ph, fac0, warm, dt)
        q1, cq = _kahan_add(ph.q, c.q, dq_inc)
        p1, cp = _kahan_add(ph.p, c.p, dp_inc)
        return (Phase(q1, p1), fac1, warm1, Phase(cq, cp))

    return Stepper(comp_init, comp_step, lambda c: c[0], order=2, symplectic=True)


#: The reference's method names; those not ported raise NotImplementedError.
FIXED_METHODS = (
    "rk4",
    "leapfrog",
    "leapfrog_fused",
    "midpoint",
    "gauss4",
    "gauss6",
    "yoshida4",
    "yoshida4_fused",
    "suzuki4_fused",
    "tao2",
    "tao4",
)

_PORTED = ("leapfrog", "leapfrog_fused", "yoshida4_fused", "suzuki4_fused")


def make_stepper(
    system: System,
    method: str = "gauss4",
    *,
    iters=6,
    compensated: bool = False,
    steps_per_call: int = 1,
) -> Stepper:
    """Build a fixed-step :class:`Stepper` for ``system``.

    ``method`` is ``"leapfrog"`` (the library path over
    :func:`~hamilton_tpu_torch.mechanics.q_factor`), ``"leapfrog_fused"``
    (the fused whole-step kernel built from ``system.fused_forms``), or
    ``"yoshida4_fused"``/``"suzuki4_fused"`` (that kernel running an
    order-4 composition of substeps inside each dt-step).
    ``iters`` is an int or an ``(iters_p, iters_q)`` pair; ``compensated``
    Kahan-accumulates the increments; ``steps_per_call`` (fused only) is the
    number of dt-steps per ``step`` call, reported as ``.substeps``.
    """
    if method not in FIXED_METHODS:
        raise ValueError(
            f"unknown fixed-step method {method!r}; choose from {FIXED_METHODS}"
        )
    if method not in _PORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP M11); "
            f"ported: {_PORTED}"
        )
    if steps_per_call != 1 and not method.endswith("_fused"):
        raise ValueError(
            f"steps_per_call applies to the fused kernel methods, not {method!r}"
        )
    if method == "leapfrog":
        return _leapfrog_stepper(system, iters, compensated)
    if system.fused_forms is None:
        raise ValueError(
            f"system {system.name!r} carries no fused-kernel closed forms "
            f"(System.fused_forms); use the library leapfrog"
        )
    from hamilton_tpu_torch.ops.fused_step import FUSED_COMPOSITIONS, fused_stepper

    return fused_stepper(
        system.fused_forms(system), iters=iters, compensated=compensated,
        steps_per_call=steps_per_call, composition=FUSED_COMPOSITIONS[method],
    )
