"""Two-body Kepler orbit (counterpart of :mod:`hamilton_tpu.models.two_body`,
reference ``twoBody``, ``app/Examples.hs:118-142``).

Polar generalized coordinates ``(r, θ)`` about the center of mass; gravity
``U = −m₁m₂/r``.  Bodies orbit only if ``H < 0``.
"""

from __future__ import annotations

import torch

from hamilton_tpu_torch.models.base import Example
from hamilton_tpu_torch.state import Config
from hamilton_tpu_torch.system import mk_system

__all__ = ["two_body"]


def two_body(
    m1: float = 5.0, m2: float = 0.5, omega0: float = 0.5, *, device, dtype: torch.dtype
) -> Example:
    """Two gravitating bodies (CLI defaults m1=5, m2=0.5, ω0=0.5).

    Positions assume (0,0) is the center of mass: ``r₁ = −(m₂/mT)·r``,
    ``r₂ = (m₁/mT)·r`` along ``(cos θ, sin θ)``.  Initial state
    ``q = (2, 0)``, ``q̇ = (0, ω0)``.
    """
    params = {"m1": m1, "m2": m2}

    def inertia_fn(p):
        return torch.stack([p["m1"], p["m1"], p["m2"], p["m2"]])

    def coords(q, p):
        r, th = q[0], q[1]
        m_t = p["m1"] + p["m2"]
        r1 = r * (-(p["m2"] / m_t)).to(q.dtype)
        r2 = r * (p["m1"] / m_t).to(q.dtype)
        c, s = torch.cos(th), torch.sin(th)
        return torch.stack([r1 * c, r1 * s, r2 * c, r2 * s])

    def potential(q, p):
        return -(p["m1"] * p["m2"]).to(q.dtype) / q[0]

    # fused whole-step forms: in the COM polar coordinates the mass matrix is
    # diagonal, K = diag(μ, μ·r²) with the reduced mass μ = m₁m₂/(m₁+m₂), and
    #   ∂H/∂r = m₁m₂/r² − μ·r·w_θ²,   ∂H/∂θ = 0
    # (angular-momentum conservation, exact in the closed forms).
    # U = −m₁m₂/r.  Coefficient table: (μ, m₁m₂).
    def fused_forms(system):
        from hamilton_tpu_torch.ops.fused_step import (
            FamilyFns, FusedForms, concrete_scalar,
        )

        p = system.params
        m1_c = concrete_scalar(p["m1"])
        m2_c = concrete_scalar(p["m2"])
        consts = None
        if m1_c is not None and m2_c is not None:
            consts = ((m1_c * m2_c / (m1_c + m2_c), m1_c * m2_c),)

        def arrays_fn(dtype, device):
            m1_ = p["m1"].to(device=device, dtype=dtype)
            m2_ = p["m2"].to(device=device, dtype=dtype)
            mm = m1_ * m2_
            return (torch.stack([mm / (m1_ + m2_), mm], dim=-1),)

        def make(at, fm):
            mu = lambda: at[0](0)  # noqa: E731  reduced mass
            mm = lambda: at[0](1)  # noqa: E731  m₁·m₂

            def aux(q):
                return (1.0 / q[0],)  # 1/r

            def k_at(aux_v, q):
                inv_r = aux_v[0]

                def at_(i, j):
                    if (i, j) == (0, 0):
                        return fm.full(mu(), inv_r)
                    if (i, j) == (1, 1):
                        return mu() * (q[0] * q[0])
                    return fm.zero(inv_r)

                return at_

            def dhdq(aux_v, q, w):
                inv_r = aux_v[0]
                return [
                    mm() * (inv_r * inv_r) - mu() * q[0] * (w[1] * w[1]),
                    fm.zero(inv_r),
                ]

            def potential(aux_v, q):
                return fm.zero(aux_v[0]) - mm() * aux_v[0]

            return FamilyFns(aux, k_at, dhdq, potential)

        return FusedForms(
            n=2, n_aux=1, coef_lens=(2,), consts=consts, make=make,
            name="two_body", arrays_fn=arrays_fn,
        )

    system = mk_system(
        None, coords, potential, device=device, dtype=dtype, n=2, name="two_body",
        params=params, inertia_fn=inertia_fn, fused_forms=fused_forms,
    )

    def draw(xs):
        return [xs[0:2], xs[2:4]]

    return Example(
        name="Two-Body",
        coord_names=("r", "θ"),
        system=system,
        draw=draw,
        init_config=Config(
            torch.tensor([2.0, 0.0], device=device, dtype=dtype),
            torch.tensor([0.0, omega0], device=device, dtype=dtype),
        ),
    )
