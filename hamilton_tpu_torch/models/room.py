"""Ball in a room (counterpart of :mod:`hamilton_tpu.models.room`, reference
``room``, ``app/Examples.hs:96-116``).

Identity coordinate map; the walls are soft constraints modeled purely by
the potential (logistic barriers).
"""

from __future__ import annotations

import math

import torch

from hamilton_tpu_torch.models.base import Example, logistic
from hamilton_tpu_torch.state import Config
from hamilton_tpu_torch.system import mk_system

__all__ = ["room"]

# the walls' logistic steepness β = log 9 / width and height (see
# ``base.logistic``), as Python floats: the forms multiply them into the
# member values in the state's type, as the reference's do
_BETA = math.log(9.0) / 0.1
_HT = 10.0


def room(theta: float = math.pi / 4, *, device, dtype: torch.dtype) -> Example:
    """Ball launched at angle ``theta`` (radians).

    Potential: gravity ``2y`` plus four logistic walls at ``y = ±1`` and
    ``x = ±2``.  Initial state ``q = (−1, 0.25)``, ``q̇ = (cos θ, sin θ)``.
    """
    bottom = logistic(-1.0, 10.0, 0.1)
    top = logistic(1.0, 10.0, 0.1)
    left = logistic(-2.0, 10.0, 0.1)
    right = logistic(2.0, 10.0, 0.1)

    def potential(q):
        x, y = q[0], q[1]
        return 2.0 * y + (1.0 - bottom(y)) + top(y) + (1.0 - left(x)) + right(x)

    # fused whole-step forms: identity coordinates with unit masses make
    # K = I and ∂H/∂q = ∇U, the walls differentiating to ht·β·σ·(1−σ) plus
    # the constant gravity 2 in y.  No parameters: the forms always have the
    # shared (empty) table.
    def fused_forms(system):
        from hamilton_tpu_torch.ops.fused_step import FamilyFns, FusedForms

        def make(at, fm):
            def sigma(z):
                return 1.0 / (1.0 + fm.exp(0.0 - z))

            def wall_grad(v, pos):
                """−lo'(v) + hi'(v) for the wall pair at v = ∓pos."""
                sl = sigma(_BETA * (v + pos))
                sh = sigma(_BETA * (v - pos))
                hb = _HT * _BETA
                return hb * (sh * (1.0 - sh)) - hb * (sl * (1.0 - sl))

            def aux(q):
                return ()

            def k_at(aux_v, q):
                def at_(i, j):
                    if i == j:
                        return fm.full(1.0, q[0])
                    return fm.zero(q[0])

                return at_

            def dhdq(aux_v, q, w):
                return [
                    wall_grad(q[0], 2.0),
                    2.0 + wall_grad(q[1], 1.0),
                ]

            def potential(aux_v, q):
                def wall_pair(v, pos):
                    lo = _HT * sigma(_BETA * (v + pos))
                    hi = _HT * sigma(_BETA * (v - pos))
                    return (1.0 - lo) + hi

                return 2.0 * q[1] + wall_pair(q[0], 2.0) + wall_pair(q[1], 1.0)

            return FamilyFns(aux, k_at, dhdq, potential)

        return FusedForms(n=2, n_aux=0, coef_lens=(), consts=(), make=make, name="room")

    system = mk_system(
        [1.0, 1.0], lambda q: q, potential, device=device, dtype=dtype, n=2,
        name="room", fused_forms=fused_forms,
    )

    def draw(xs):
        return [xs]

    return Example(
        name="Room",
        coord_names=("x", "y"),
        system=system,
        draw=draw,
        init_config=Config(
            torch.tensor([-1.0, 0.25], device=device, dtype=dtype),
            torch.tensor([math.cos(theta), math.sin(theta)], device=device, dtype=dtype),
        ),
    )
