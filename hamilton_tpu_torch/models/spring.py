"""Spring hanging from a block on a rail (counterpart of
:mod:`hamilton_tpu.models.spring`, reference ``spring``,
``app/Examples.hs:144-162``).

``System 3 3`` with no analytic Jacobian or mass matrix: its library path
forms ``√M·J`` by AD and solves through the J-route kernels (K2d, K2e).  Its
fused whole-step forms state K, ∂H/∂q and U in closed form.
"""

from __future__ import annotations

import math

import torch

from hamilton_tpu_torch.models.base import Example, logistic
from hamilton_tpu_torch.state import Config
from hamilton_tpu_torch.system import mk_system

__all__ = ["spring"]

# the rail walls' logistic steepness β = log 9 / width, height and position
_WALL_BETA = math.log(9.0) / 0.1
_WALL_HT = 25.0
_WALL_POS = 1.5


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

    # fused whole-step forms: K = JᵀMJ of the rail map above is
    #   ⎡ mB+mW   mW·sinθ      mW·(1+x)·cosθ ⎤
    #   ⎢ mW·sinθ mW           0             ⎥
    #   ⎣ …       0            mW·(1+x)²     ⎦
    # with kinetic gradients ∂T/∂x|_w = mW(c·w_r·w_θ + (1+x)·w_θ²) and
    # ∂T/∂θ|_w = mW·w_r·(c·w_x − (1+x)·s·w_θ); the rail walls enter ∇U_r as
    # logistic derivatives ht·β·σ·(1−σ).  Coefficient table: (mB+mW, mW, k, mB).
    def fused_forms(system):
        from hamilton_tpu_torch.ops.fused_step import (
            FamilyFns, FusedForms, concrete_scalar,
        )

        p = system.params
        mb_c = concrete_scalar(p["m_block"])
        mw_c = concrete_scalar(p["m_weight"])
        k_c = concrete_scalar(p["k"])
        consts = None
        if mb_c is not None and mw_c is not None and k_c is not None:
            consts = ((mb_c + mw_c, mw_c, k_c, mb_c),)

        def arrays_fn(dtype, device):
            mb_, mw_, k_ = (p[k].to(device=device, dtype=dtype)
                            for k in ("m_block", "m_weight", "k"))
            return (torch.stack([mb_ + mw_, mw_, k_, mb_], dim=-1),)

        def make(at, fm):
            mbw = lambda: at[0](0)  # noqa: E731  mB + mW
            mw = lambda: at[0](1)   # noqa: E731
            kk = lambda: at[0](2)   # noqa: E731
            mb = lambda: at[0](3)   # noqa: E731

            def sigma(z):
                return 1.0 / (1.0 + fm.exp(0.0 - z))

            def wall_grad(r):
                """−left'(r) + right'(r) for the rail walls at r = ∓1.5."""
                sl = sigma(_WALL_BETA * (r + _WALL_POS))
                sr = sigma(_WALL_BETA * (r - _WALL_POS))
                hb = _WALL_HT * _WALL_BETA
                return hb * (sr * (1.0 - sr)) - hb * (sl * (1.0 - sl))

            def aux(q):
                return (fm.sin(q[2]), fm.cos(q[2]))

            def k_at(aux_v, q):
                s, c = aux_v
                opx = 1.0 + q[1]

                def at_(i, j):
                    if (i, j) == (0, 0):
                        return fm.full(mbw(), s)
                    if (i, j) == (1, 0):
                        return mw() * s
                    if (i, j) == (1, 1):
                        return fm.full(mw(), s)
                    if (i, j) == (2, 0):
                        return mw() * (opx * c)
                    if (i, j) == (2, 2):
                        return mw() * (opx * opx)
                    return fm.zero(s)

                return at_

            def dhdq(aux_v, q, w):
                s, c = aux_v
                opx = 1.0 + q[1]
                return [
                    wall_grad(q[0]),
                    kk() * q[1] - mb() * c
                    - mw() * (c * (w[0] * w[2]) + opx * (w[2] * w[2])),
                    mb() * (opx * s)
                    - mw() * (w[0] * (c * w[1] - (opx * s) * w[2])),
                ]

            def potential(aux_v, q):
                _, c = aux_v
                opx = 1.0 + q[1]
                lft = _WALL_HT * sigma(_WALL_BETA * (q[0] + _WALL_POS))
                rgt = _WALL_HT * sigma(_WALL_BETA * (q[0] - _WALL_POS))
                return (
                    kk() * (q[1] * q[1]) * 0.5
                    + (1.0 - lft) + rgt
                    - mb() * (opx * c)
                )

            return FamilyFns(aux, k_at, dhdq, potential)

        return FusedForms(
            n=3, n_aux=2, coef_lens=(4,), consts=consts, make=make,
            name="spring", arrays_fn=arrays_fn,
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
