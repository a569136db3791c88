"""Plain PyTorch reference of the planar serial pendulum chain and of the
fixed-step integrator the benchmarked ensembles run on it.

It imports nothing of the program under test.  The physics is written from
the published systems (``configs/*.json``): bob ``i`` at
``x_i = Σ_{j≤i} l_j sin q_j``, ``y_i = Σ_{j≤i} l_j (1 − cos q_j)``, kinetic
energy ``½ q̇ᵀ K(q) q̇`` with ``K_ij = l_i l_j S_max(i,j) cos(q_i − q_j)``
(``S_r`` the mass of bobs ``r..n``), potential ``g Σ m_i y_i`` plus a
constant.  Every linear solve goes through ``K⁻¹``, formed from a dense
Cholesky factor of ``K`` (batched triangular solves on the card are fast
where ``torch.cholesky_solve`` is not: 1.1 ms against 0.06 ms a solve at
16384 × 20 on an H100).

The integrator is the generalized Störmer-Verlet step as the configurations
state it: ``iters = (i_p, i_q)`` fixed-point sweeps, the force and the
velocity derivative of the last step warm-starting the next, and the mass
matrix factored afresh at the first step of every launch (every
``steps_per_call`` steps) and otherwise carried from the previous step (at
its predictor when ``i_q = 0``, at its corrected position otherwise).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

__all__ = ["SerialChain", "StepState", "follow"]


class StepState(NamedTuple):
    """``(B, n)`` columns: position, momentum, the last force ``∂H/∂q`` and
    the last velocity derivative (both zero at a cold start)."""

    q: torch.Tensor
    p: torch.Tensor
    force: torch.Tensor
    vdot: torch.Tensor


class SerialChain:
    """The chain's mass matrix, Hamiltonian and ``∂H/∂q`` in ``dtype``.

    For ``torch.bfloat16`` (the lower-precision control) every elementwise
    operation of the step runs in bfloat16, and the mass matrix, its
    inverse and each solve run in float32 on bfloat16 operands, rounded
    back to bfloat16: ``torch.linalg`` has no bfloat16 factorization, and a
    mass matrix formed in bfloat16 is not positive definite at 20 links."""

    def __init__(self, masses: Sequence[float], lengths: Sequence[float], gravity: float,
                 potential_offset: float = 0.0, *, dtype=torch.float64, device="cpu"):
        if len(masses) != len(lengths) or not masses:
            raise ValueError(f"need one length a mass, got {len(masses)} and {len(lengths)}")
        m = torch.tensor(masses, dtype=torch.float64)
        ln = torch.tensor(lengths, dtype=torch.float64)
        suffix = torch.flip(torch.cumsum(torch.flip(m, (0,)), 0), (0,))
        self.n = len(masses)
        self.dtype = dtype
        self.coupling = (ln[:, None] * ln[None, :]
                         * torch.minimum(suffix[:, None], suffix[None, :])).to(device, dtype)
        self.gravity_terms = (gravity * ln * suffix).to(device, dtype)
        self.potential_offset = float(potential_offset)
        self._solve_dtype = torch.float32 if dtype == torch.bfloat16 else dtype

    def mass_matrix(self, q: torch.Tensor) -> torch.Tensor:
        coupling = self.coupling.to(q.dtype)
        return coupling * torch.cos(q[:, :, None] - q[:, None, :])

    def factor(self, q: torch.Tensor) -> torch.Tensor:
        """``K(q)⁻¹`` from its Cholesky factor ``L``: ``L⁻ᵀ L⁻¹``."""
        k = self.mass_matrix(q.to(self._solve_dtype))
        low = torch.linalg.cholesky_ex(k)[0]  # no sync on its info: the queue stays full
        eye = torch.eye(self.n, dtype=k.dtype, device=k.device).expand_as(k)
        low_inv = torch.linalg.solve_triangular(low, eye, upper=False)
        return low_inv.mT @ low_inv

    def solve(self, k_inv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return (k_inv * b.to(self._solve_dtype)[:, None, :]).sum(-1).to(self.dtype)

    def potential(self, q: torch.Tensor) -> torch.Tensor:
        return (self.gravity_terms * (1.0 - torch.cos(q))).sum(-1) + self.potential_offset

    def dhdq(self, q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``∂H/∂q`` at ``q`` with ``v`` standing for ``K(q)⁻¹ p``:
        ``v_k Σ_j K'_kj sin(q_k − q_j) v_j + g l_k S_k sin q_k``."""
        s = self.coupling * torch.sin(q[:, :, None] - q[:, None, :])
        return v * (s @ v[..., None])[..., 0] + self.gravity_terms * torch.sin(q)

    def hamiltonian(self, q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        v = self.solve(self.factor(q), p)
        return 0.5 * (p * v).sum(-1) + self.potential(q)


def follow(chain: SerialChain, state: StepState, dt: float, steps: int, *,
           iters: Tuple[int, int], steps_per_call: int) -> StepState:
    """``steps`` steps from ``state``, which sits at a launch boundary."""
    iters_p, iters_q = iters
    q, p, force, vdot = (t.to(chain.dtype) for t in state)
    half = dt * 0.5
    carried = None
    for k in range(steps):
        inv0 = chain.factor(q) if k % steps_per_call == 0 else carried
        ph = p - half * force
        force0 = force
        for _ in range(iters_p):
            force0 = chain.dhdq(q, chain.solve(inv0, ph))
            ph = p - half * force0
        v0 = chain.solve(inv0, ph)
        q1 = q + dt * v0 + (dt * half) * vdot
        if iters_q == 0:
            carried = chain.factor(q1)
            v1 = chain.solve(carried, ph)
            q1 = q + half * (v0 + v1)
            force1 = chain.dhdq(q1, v1)
        else:
            for _ in range(iters_q):
                v1 = chain.solve(chain.factor(q1), ph)
                q1 = q + half * (v0 + v1)
            carried = chain.factor(q1)
            force1 = chain.dhdq(q1, chain.solve(carried, ph))
        q, p = q1, p - half * (force0 + force1)
        vdot = (v1 - v0) / dt
        force = force1
    return StepState(q, p, force, vdot)
