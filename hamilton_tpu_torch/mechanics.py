"""Mechanics core: mass matrix, state conversions, energies, Hamilton's equations.

PyTorch counterpart of :mod:`hamilton_tpu.mechanics`.  Every function is
batch-aware: states carry any leading batch axes (``q: (..., n)``, an
ensemble is ``(B, n)``), and member-level physics is mapped over them with
``torch.func.vmap``.  ``K = JᵀMJ`` is solved by Cholesky, and the rank-3
Hessian contraction of Hamilton's equations is a VJP-of-JVP sweep that never
materializes the ``m·n²`` tensor.

On a batched state the solves go to the batched tiny-SPD entries
(:mod:`~hamilton_tpu_torch.ops.batched_spd`), routed as the reference routes
them: a system with an analytic ``mass_matrix_fn`` (the K route) solves with
K through :mod:`~hamilton_tpu_torch.ops.linalg`; any other system (the J
route) hands ``√M·J`` to the entries that form K inside the kernel, so K is
never stored.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jvp, vjp

from hamilton_tpu_torch.ops.batched_spd import cholesky_jac, jac_scaled, spd_solve_jac
from hamilton_tpu_torch.ops.linalg import (
    kernel_route,
    small_cho_solve,
    small_cholesky,
    spd_solve,
)
from hamilton_tpu_torch.state import Config, Phase
from hamilton_tpu_torch.system import System, map_member

__all__ = [
    "mass_matrix",
    "momenta",
    "velocities",
    "to_phase",
    "from_phase",
    "pe",
    "ke_c",
    "ke_p",
    "lagrangian",
    "hamiltonian",
    "ham_eqs",
    "ham_rhs",
    "QFactor",
    "q_factor",
    "dhdp_factored",
    "dhdq_factored",
]


def _jacobian(system: System, q: torch.Tensor) -> torch.Tensor:
    """J(q) with leading batch axes: (..., m, n)."""
    return map_member(system, lambda qq, pp: system.jacobian(qq, pp), q)


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``A @ v`` for A (..., m, n), v (..., n)."""
    return torch.sum(a * v[..., None, :], dim=-1)


def _tmv(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``Aᵀ @ u`` for A (..., m, n), u (..., m)."""
    return torch.sum(a * u[..., :, None], dim=-2)


def _form_k(j: torch.Tensor, inertia: torch.Tensor) -> torch.Tensor:
    """``K = JᵀMJ`` (..., n, n) from J (..., m, n); an inertia derived from
    batched params carries leading batch axes that align with J's."""
    inertia = inertia.to(j.dtype)
    if inertia.ndim == 1:
        return torch.einsum("...mi,m,...mj->...ij", j, inertia, j)
    return torch.einsum("...mi,...mj->...ij", j * inertia[..., :, None], j)


def _grad_u(system: System, q: torch.Tensor) -> torch.Tensor:
    return map_member(system, lambda qq, pp: system.potential_grad(qq, pp), q)


def mass_matrix(system: System, q: torch.Tensor) -> torch.Tensor:
    """Generalized mass matrix ``K(q) = J(q)ᵀ M J(q)``, shape ``(..., n, n)``;
    an analytic ``mass_matrix_fn`` replaces the Jacobian contraction."""
    fn = system.mass_matrix_fn
    if fn is not None:
        if system.has_params:
            return map_member(system, fn, q)
        return map_member(system, lambda qq, _p: fn(qq), q)
    return _form_k(_jacobian(system, q), system.inertia)


def momenta(system: System, config: Config) -> torch.Tensor:
    """Conjugate momenta ``p = JᵀMJ q̇``."""
    if system.mass_matrix_fn is not None:
        return _mv(mass_matrix(system, config.q), config.v)
    j = _jacobian(system, config.q)
    return _tmv(j, system.inertia.to(j.dtype) * _mv(j, config.v))


def _k_solve(system: System, q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``K(q)⁻¹ b``: the K route through :func:`spd_solve`, the J route through
    the form-K+factor+solve entry (K2d) on a batched state."""
    if system.mass_matrix_fn is not None:
        return spd_solve(mass_matrix(system, q), b)
    j = _jacobian(system, q)
    if kernel_route(j, b):
        return spd_solve_jac(jac_scaled(j, system.inertia), b)
    return spd_solve(_form_k(j, system.inertia), b)


def velocities(system: System, phase: Phase) -> torch.Tensor:
    """Generalized velocities ``q̇ = (JᵀMJ)⁻¹ p`` via Cholesky."""
    return _k_solve(system, phase.q, phase.p)


def to_phase(system: System, config: Config) -> Phase:
    """Configuration space → phase space."""
    return Phase(config.q, momenta(system, config))


def from_phase(system: System, phase: Phase) -> Config:
    """Phase space → configuration space."""
    return Config(phase.q, velocities(system, phase))


def pe(system: System, q: torch.Tensor) -> torch.Tensor:
    """Potential energy ``U(q)``; shape ``(...)`` for ``q (..., n)``."""
    return map_member(system, lambda qq, pp: system.potential_value(qq, pp), q)


def ke_c(system: System, config: Config) -> torch.Tensor:
    """Kinetic energy from configuration space: ``⟨q̇, p⟩ / 2``."""
    return torch.sum(config.v * momenta(system, config), dim=-1) / 2


def ke_p(system: System, phase: Phase) -> torch.Tensor:
    """Kinetic energy from phase space: ``⟨p, q̇⟩ / 2``."""
    return torch.sum(phase.p * velocities(system, phase), dim=-1) / 2


def lagrangian(system: System, config: Config) -> torch.Tensor:
    """``L = T − U``."""
    return ke_c(system, config) - pe(system, config.q)


def hamiltonian(system: System, phase: Phase) -> torch.Tensor:
    """``H = T + U``."""
    return ke_p(system, phase) + pe(system, phase.q)


def _dtdq(system: System, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kinetic part of ``∂H/∂q`` at fixed velocity ``w``:
    ``−uᵀ (∂J/∂q_k) w`` with ``u = M·J·w``, as one VJP of ``q ↦ J(q)·w``.

    ``J·w`` is the primal output of the linearization, so the cotangent
    ``u`` costs no extra pass and no Jacobian is materialized.  An analytic
    ``system.dtdq_fn`` (∂T/∂q at fixed w) replaces the sweep outright; this
    function returns the kinetic part of ∂H/∂q, which is −∂T/∂q|_w (the
    Legendre identity), hence the negation of the override."""
    if system.dtdq_fn is not None:
        fn = system.dtdq_fn
        if system.has_params:
            return -map_member(system, fn, q, w)
        return -map_member(system, lambda qq, ww, _p: fn(qq, ww), q, w)

    def one(qi, wi, inert, pp):
        coords1 = system.coords_bound(pp)

        def jw(qq):
            return jvp(coords1, (qq,), (wi,))[1]

        jw_val, vjp_fn = vjp(jw, qi)
        # in q's dtype (see System.jacobian)
        return -vjp_fn((inert * jw_val).to(jw_val.dtype))[0].to(qi.dtype)

    # the inertia, shared or batched like the members, broadcast to the
    # state's batch axes and mapped with it
    inertia = system.inertia.to(q.dtype)
    inertia = inertia.expand(*q.shape[:-1], inertia.shape[-1])
    return map_member(system, one, q, w, inertia)


def ham_eqs(system: System, phase: Phase) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hamilton's equations: ``(q̇, ṗ) = (∂H/∂p, −∂H/∂q)``."""
    q, p = phase.q, phase.p
    w = _k_solve(system, q, p)
    dhdq = _dtdq(system, q, w) + _grad_u(system, q)
    return w, -dhdq


def ham_rhs(system: System):
    """The right-hand side on flat states ``y = [q, p]`` ``(..., 2n)``:
    flatten ∘ :func:`ham_eqs` ∘ unflatten, for the integrator drivers."""

    def rhs(y: torch.Tensor) -> torch.Tensor:
        dq, dp = ham_eqs(system, Phase.unflatten(y))
        return torch.cat([dq, dp], dim=-1)

    return rhs


class QFactor(NamedTuple):
    """Position-dependent factorization of the dynamics, reused while ``q``
    is held fixed (the leapfrog's inner loops, and across steps)."""

    chol: torch.Tensor  # lower Cholesky factor of K(q): (..., n, n)
    grad_u: torch.Tensor  # ∇U(q), (..., n)


def q_factor(system: System, q: torch.Tensor) -> QFactor:
    """Factorize the q-dependent parts of :func:`ham_eqs` once (on the J
    route, a batched state's factor comes straight from √M·J: K2e)."""
    if system.mass_matrix_fn is not None:
        chol = small_cholesky(mass_matrix(system, q))
    else:
        j = _jacobian(system, q)
        if kernel_route(j):
            chol = cholesky_jac(jac_scaled(j, system.inertia))
        else:
            chol = small_cholesky(_form_k(j, system.inertia))
    return QFactor(chol, _grad_u(system, q))


def dhdp_factored(factor: QFactor, p: torch.Tensor) -> torch.Tensor:
    """``∂H/∂p = q̇ = K⁻¹p`` from a cached factor — substitutions only."""
    return small_cho_solve(factor.chol, p)


def dhdq_factored(
    system: System, factor: QFactor, q: torch.Tensor, p: torch.Tensor
) -> torch.Tensor:
    """``∂H/∂q`` from a cached factor: only the w-dependent sweep is
    recomputed."""
    w = small_cho_solve(factor.chol, p)
    return _dtdq(system, q, w) + factor.grad_u
