"""Fixed-step integrators (counterpart of :mod:`hamilton_tpu.integrators.fixed`).

Every method of the reference, by name:

* ``leapfrog`` — the generalized Störmer-Verlet scheme (Hairer et al.,
  *Geometric Numerical Integration*, VI.3) for the non-separable
  ``H = ½ pᵀK(q)⁻¹p + U(q)``, semi-implicit, solved by a static number of
  fixed-point iterations over a cached factor: order 2, symmetric,
  symplectic;
* ``midpoint`` / ``gauss4`` / ``gauss6`` — Gauss-Legendre collocation
  (orders 2/4/6), symplectic and symmetric, fixed-point iterated a static
  number of times; ``gauss4`` is the default;
* ``tao2`` / ``tao4`` — Molei Tao's explicit symplectic scheme for
  non-separable Hamiltonians (PRE 94, 043303 (2016)) on the extended phase
  space ``(q, p, x, y)`` with an ω-binding; ``tao4`` is its triple jump;
* ``yoshida4`` — the triple-jump composition of ``leapfrog``;
* ``rk4`` — classical explicit Runge-Kutta, not symplectic, for reference;
* ``leapfrog_fused`` and its order-4 compositions ``yoshida4_fused`` (the
  triple jump) and ``suzuki4_fused`` (Suzuki's five stages): the fused
  whole-step kernel, :mod:`hamilton_tpu_torch.ops.fused_step`.

Each stage of the implicit and explicit methods is one
:func:`~hamilton_tpu_torch.mechanics.ham_eqs` call on the whole batch, so on
a CUDA tensor its solve is one batched tiny-SPD kernel launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from hamilton_tpu_torch.integrators.tableaus import GAUSS2, GAUSS4, GAUSS6, RK4, Tableau
from hamilton_tpu_torch.mechanics import (
    dhdp_factored,
    dhdq_factored,
    ham_eqs,
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


def _rhs(system: System):
    def rhs(phase: Phase) -> Phase:
        dq, dp = ham_eqs(system, phase)
        return Phase(dq, dp)

    return rhs


def _kahan_add(x, c, d):
    """Compensated accumulation: add increment ``d`` to ``(x, c)`` where ``c``
    carries the running rounding residual.  PyTorch does not reassociate
    floating point, so the cancellation pattern survives; the accumulation
    error stays O(eps) instead of random-walking as O(√N·eps·|y|)."""
    y = d + c
    t = x + y
    c_new = y - (t - x)
    return t, c_new


# ----------------------------------------------------------------------
# Explicit RK on phase space
# ----------------------------------------------------------------------


def _explicit_rk_stepper(system: System, tab: Tableau) -> Stepper:
    rhs = _rhs(system)

    def step(ph: Phase, dt) -> Phase:
        ks = []
        for i in range(tab.stages):
            qi, pi = ph.q, ph.p
            for j, aij in enumerate(tab.a[i]):
                if aij != 0.0:
                    qi = qi + dt * aij * ks[j].q
                    pi = pi + dt * aij * ks[j].p
            ks.append(rhs(Phase(qi, pi)))
        q1, p1 = ph.q, ph.p
        for bi, ki in zip(tab.b, ks):
            if bi != 0.0:
                q1 = q1 + dt * bi * ki.q
                p1 = p1 + dt * bi * ki.p
        return Phase(q1, p1)

    return Stepper(lambda p: p, step, lambda p: p, order=tab.order, symplectic=False)


# ----------------------------------------------------------------------
# Gauss-Legendre collocation (symplectic implicit RK), fixed-point solved
# ----------------------------------------------------------------------


def _stage_combine(mat: torch.Tensor, fs: torch.Tensor) -> torch.Tensor:
    """``(s', s) × (s, ..., n) → (s', ..., n)``: ``Σ_j mat_ij F_j`` as
    elementwise products and a sum (no matmul, so no TF32 on a card)."""
    return (mat.reshape(mat.shape + (1,) * (fs.ndim - 1)) * fs).sum(dim=1)


def _gauss_stepper(
    system: System, tab: Tableau, iters: int, compensated: bool = False
) -> Stepper:
    rhs = _rhs(system)
    s = tab.stages
    # Folding the s stages into the batch axis makes one ham_eqs call (one
    # batched solve) serve s·B members; with BATCHED params or inertia that
    # would break the trailing alignment of the state's batch axes with the
    # system's, so the stages stay a leading axis instead (map_member holds
    # the params fixed over it).
    fold_stages = system.member_batch_ndim() == 0
    coeffs = {}

    def tables(like: torch.Tensor):
        """The tableau's ``a`` and ``b`` in ``like``'s dtype and on its
        device, copied there once."""
        key = (like.dtype, like.device)
        if key not in coeffs:
            coeffs[key] = tuple(torch.tensor(x, dtype=like.dtype, device=like.device)
                                for x in (tab.a, tab.b))
        return coeffs[key]

    def increments(ph: Phase, dt):
        """Stage derivatives ``F_i ← f(y + dt Σ_j a_ij F_j)``, fixed-point
        iterated ``iters`` times from ``F_i = f(y)``, and the step in
        increment form ``Δ = dt·Σ b_i F_i``: O(dt·|y|) with O(eps·dt·|y|)
        rounding, what the compensated path accumulates."""
        a_mat, b_vec = tables(ph.q)
        f0 = rhs(ph)
        fq = f0.q.expand((s,) + f0.q.shape)
        fp = f0.p.expand((s,) + f0.p.shape)
        n = ph.q.shape[-1]
        # an unrolled loop, as the reference's (a static small count)
        for _ in range(iters):
            qi = ph.q + dt * _stage_combine(a_mat, fq)  # (s, ..., n)
            pi = ph.p + dt * _stage_combine(a_mat, fp)
            if fold_stages:
                # (s, ..., n) → (s·B, n): one batched solve for every stage
                dq, dp = ham_eqs(system, Phase(qi.reshape(-1, n), pi.reshape(-1, n)))
                fq, fp = dq.reshape(qi.shape), dp.reshape(pi.shape)
            else:
                fq, fp = ham_eqs(system, Phase(qi, pi))
        dq_inc = dt * _stage_combine(b_vec[None, :], fq)[0]
        dp_inc = dt * _stage_combine(b_vec[None, :], fp)[0]
        return dq_inc, dp_inc

    if not compensated:

        def step(ph: Phase, dt) -> Phase:
            dq_inc, dp_inc = increments(ph, dt)
            return Phase(ph.q + dq_inc, ph.p + dp_inc)

        return Stepper(lambda p: p, step, lambda p: p, order=tab.order, symplectic=True)

    def comp_init(ph: Phase):
        return (ph, Phase(torch.zeros_like(ph.q), torch.zeros_like(ph.p)))

    def comp_step(carry, dt):
        ph, c = carry
        dq_inc, dp_inc = increments(ph, dt)
        q1, cq = _kahan_add(ph.q, c.q, dq_inc)
        p1, cp = _kahan_add(ph.p, c.p, dp_inc)
        return (Phase(q1, p1), Phase(cq, cp))

    return Stepper(comp_init, comp_step, lambda carry: carry[0], order=tab.order,
                   symplectic=True)


# ----------------------------------------------------------------------
# Generalized Störmer-Verlet ("leapfrog") for non-separable H
# ----------------------------------------------------------------------


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


# ----------------------------------------------------------------------
# Tao's explicit symplectic integrator for non-separable H (PRE 2016)
# ----------------------------------------------------------------------


class _TaoState(NamedTuple):
    """The extended phase-space state: the physical copy ``(q, p)`` and the
    shadow copy ``(x, y)``."""

    q: torch.Tensor
    p: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor


def _tao_flows(system: System, omega: float):
    def phi_a(st: _TaoState, d) -> _TaoState:
        # H_A = H(q, y): p ← p − δ H_q(q, y); x ← x + δ H_p(q, y)
        dq, dp = ham_eqs(system, Phase(st.q, st.y))
        return _TaoState(st.q, st.p + d * dp, st.x + d * dq, st.y)

    def phi_b(st: _TaoState, d) -> _TaoState:
        # H_B = H(x, p): q ← q + δ H_p(x, p); y ← y − δ H_q(x, p)
        dq, dp = ham_eqs(system, Phase(st.x, st.p))
        return _TaoState(st.q + d * dq, st.p, st.x, st.y + d * dp)

    def phi_c(st: _TaoState, d) -> _TaoState:
        # ω-binding rotation of (q−x, p−y), the exact linear flow; d is a
        # tensor on the state's device, so its cosine stays there too
        ang = 2.0 * omega * d
        cth, sth = torch.cos(ang), torch.sin(ang)
        dq, dp = st.q - st.x, st.p - st.y
        sq, sp = st.q + st.x, st.p + st.y
        rq = cth * dq + sth * dp
        rp = -sth * dq + cth * dp
        return _TaoState(
            0.5 * (sq + rq), 0.5 * (sp + rp), 0.5 * (sq - rq), 0.5 * (sp - rp)
        )

    return phi_a, phi_b, phi_c


def _tao2_step(system: System, omega: float):
    phi_a, phi_b, phi_c = _tao_flows(system, omega)

    def step(st: _TaoState, dt) -> _TaoState:
        h = dt / 2
        st = phi_a(st, h)
        st = phi_b(st, h)
        st = phi_c(st, dt)
        st = phi_b(st, h)
        st = phi_a(st, h)
        return st

    return step


def _tao_stepper(system: System, omega: float, order: int) -> Stepper:
    base = _tao2_step(system, omega)
    if order == 2:
        step = base
    elif order == 4:
        step = _triple_jump(base, 2)
    else:
        raise ValueError(f"tao integrator supports order 2 or 4, got {order}")

    return Stepper(
        init=lambda ph: _TaoState(ph.q, ph.p, ph.q, ph.p),
        step=step,
        extract=lambda st: Phase(0.5 * (st.q + st.x), 0.5 * (st.p + st.y)),
        order=order,
        symplectic=True,
    )


def _triple_jump(step, base_order: int):
    """Yoshida/Suzuki triple jump: raise a symmetric method's order by 2.
    The weights are Python floats, so ``w * dt`` stays where dt is."""
    gamma = 2.0 ** (1.0 / (base_order + 1))
    w1 = 1.0 / (2.0 - gamma)
    w0 = -gamma / (2.0 - gamma)

    def composed(state, dt):
        state = step(state, w1 * dt)
        state = step(state, w0 * dt)
        state = step(state, w1 * dt)
        return state

    return composed


def _yoshida4_stepper(system: System, iters) -> Stepper:
    lf = _leapfrog_stepper(system, iters)
    return Stepper(lf.init, _triple_jump(lf.step, 2), lf.extract, order=4, symplectic=True)


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------

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

_FUSED_METHODS = ("leapfrog_fused", "yoshida4_fused", "suzuki4_fused")


def _fused_factory(system: System):
    """The system's fused-stepper factory: an explicit ``pallas_step``
    override wins; otherwise one is derived from the declarative
    ``fused_forms`` family contract (:mod:`~hamilton_tpu_torch.ops.fused_step`);
    None when the system has neither."""
    if system.pallas_step is not None:
        return system.pallas_step
    if system.fused_forms is not None:
        from hamilton_tpu_torch.ops.fused_step import fused_stepper

        def factory(sys, **kw):
            return fused_stepper(sys.fused_forms(sys), **kw)

        return factory
    return None


def make_stepper(
    system: System,
    method: str = "gauss4",
    *,
    iters=6,
    omega: float = 20.0,
    compensated: bool = False,
    steps_per_call: int = 1,
) -> Stepper:
    """Build a fixed-step :class:`Stepper` for ``system``.

    Args:
      method: one of :data:`FIXED_METHODS`.
      iters: the fixed-point iteration count of the implicit members (static:
        ~5-8 suffices for ``|dt·∂²H| ≪ 1``).  For ``leapfrog``, ``yoshida4``
        and the fused methods an ``(iters_p, iters_q)`` pair splits the
        momentum- and position-loop counts (the q-loop refactors the mass
        matrix each iteration; ``iters_q=0`` is the Gauss-Seidel mode).
      omega: the binding frequency of Tao's method (larger tracks the
        physical trajectory more tightly but needs a smaller dt; ω·dt ≲ 1).
      compensated: Kahan-accumulate the step increments (the leapfrog and
        Gauss families only): long-horizon drift at the per-step level
        instead of an O(√N·eps) random walk.
      steps_per_call: the fused methods only: dt-steps run in one kernel
        launch, reported as the stepper's ``.substeps``.

    The fused methods build their stepper from ``system.pallas_step`` (a
    custom factory, called as ``pallas_step(system, iters=..., compensated=
    ..., steps_per_call=..., composition=...)``) or else from
    ``system.fused_forms``; the order-4 members run their composition's
    substeps inside each launch.
    """
    if steps_per_call != 1 and method not in _FUSED_METHODS:
        raise ValueError(
            f"steps_per_call applies to the fused kernel methods, not {method!r}"
        )
    if isinstance(iters, tuple) and method not in ("leapfrog", "yoshida4", *_FUSED_METHODS):
        raise ValueError(
            f"split (iters_p, iters_q) counts apply to leapfrog/yoshida4, "
            f"not {method!r}"
        )
    if method == "rk4":
        stepper = _explicit_rk_stepper(system, RK4)
    elif method == "leapfrog":
        return _leapfrog_stepper(system, iters, compensated)
    elif method in _FUSED_METHODS:
        factory = _fused_factory(system)
        if factory is None:
            raise ValueError(
                f"system {system.name!r} carries no fused-kernel closed forms "
                f"(System.fused_forms / System.pallas_step); use the library "
                f"leapfrog/yoshida4 methods"
            )
        from hamilton_tpu_torch.ops.fused_step import FUSED_COMPOSITIONS

        return factory(
            system, iters=iters, compensated=compensated,
            steps_per_call=steps_per_call, composition=FUSED_COMPOSITIONS[method],
        )
    elif method == "midpoint":
        return _gauss_stepper(system, GAUSS2, iters, compensated)
    elif method == "gauss4":
        return _gauss_stepper(system, GAUSS4, iters, compensated)
    elif method == "gauss6":
        return _gauss_stepper(system, GAUSS6, iters, compensated)
    elif method == "yoshida4":
        stepper = _yoshida4_stepper(system, iters)
    elif method == "tao2":
        stepper = _tao_stepper(system, omega, 2)
    elif method == "tao4":
        stepper = _tao_stepper(system, omega, 4)
    else:
        raise ValueError(
            f"unknown fixed-step method {method!r}; choose from {FIXED_METHODS}"
        )
    if compensated:
        raise ValueError(
            f"compensated summation is supported for the leapfrog/gauss "
            f"family, not {method!r}"
        )
    return stepper
