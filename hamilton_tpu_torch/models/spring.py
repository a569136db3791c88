"""Spring hanging from a block on a rail (counterpart of
:mod:`hamilton_tpu.models.spring`, reference ``spring``,
``app/Examples.hs:144-162``).

``System 3 3`` with no analytic Jacobian or mass matrix: its library path
forms ``√M·J`` by AD and solves through the J-route kernels (K2d, K2e).  Its
fused whole-step forms are ROADMAP M9.
"""

from __future__ import annotations

import torch

from hamilton_tpu_torch.models.base import Example, logistic
from hamilton_tpu_torch.state import Config
from hamilton_tpu_torch.system import mk_system

__all__ = ["spring"]


def spring(
    m_block: float = 2.0,
    m_weight: float = 1.0,
    k: float = 10.0,
    x0: float = 0.1,
    *,
    device,
    dtype: torch.dtype,
) -> Example:
    """Block (mass ``m_block``) on a rail with a spring (constant ``k``,
    initial displacement ``x0``) holding a weight (mass ``m_weight``).

    Generalized coordinates ``(r, x, θ)``: block rail position, spring
    displacement, swing angle; Cartesian map ``(r, r + (1+x)·sin θ,
    (1+x)·(−cos θ))`` with masses ``(mB, mW, mW)``; potential: spring
    ``k·x²/2`` + rail walls at ``r = ∓1.5`` + gravity ``mB·(1+x)(−cos θ)``.
    Initial state ``q = (0, x0, 0)``, ``q̇ = (1, 0, −0.5)``.
    """
    left = logistic(-1.5, 25.0, 0.1)
    right = logistic(1.5, 25.0, 0.1)
    params = {"m_block": m_block, "m_weight": m_weight, "k": k}

    def inertia_fn(p):
        return torch.stack([p["m_block"], p["m_weight"], p["m_weight"]])

    def coords(q, p):
        r, x, th = q[0], q[1], q[2]
        return torch.stack([r, r + (1.0 + x) * torch.sin(th), (1.0 + x) * (-torch.cos(th))])

    def potential(q, p):
        r, x, th = q[0], q[1], q[2]
        return (
            p["k"].to(q.dtype) * x**2 / 2.0
            + (1.0 - left(r))
            + right(r)
            + p["m_block"].to(q.dtype) * ((1.0 + x) * (-torch.cos(th)))
        )

    def fused_forms(system):
        raise NotImplementedError(
            "the spring's fused whole-step forms are not ported yet (ROADMAP M9); "
            "use the library leapfrog or evolve_ham"
        )

    system = mk_system(
        None, coords, potential, device=device, dtype=dtype, n=3, name="spring",
        params=params, inertia_fn=inertia_fn, fused_forms=fused_forms,
    )

    def draw(xs):
        # block at (r, 1); weight at (0, 1) + (x_w, y_w)
        return [torch.stack([xs[0], torch.ones_like(xs[0])]), torch.stack([xs[1], 1.0 + xs[2]])]

    return Example(
        name="Spring hanging from block",
        coord_names=("r", "x", "θ"),
        system=system,
        draw=draw,
        init_config=Config(
            torch.tensor([0.0, x0, 0.0], device=device, dtype=dtype),
            torch.tensor([1.0, 0.0, -0.5], device=device, dtype=dtype),
        ),
    )
