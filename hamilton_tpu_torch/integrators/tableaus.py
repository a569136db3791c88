"""Butcher tableaus for the Runge-Kutta integrator family.

A copy of :mod:`hamilton_tpu.integrators.tableaus`, which is framework-free
data: the port cannot import it, because importing ``hamilton_tpu`` imports
JAX.  ``tests/test_torch_adaptive.py`` holds the two copies equal.

``RKF45`` reproduces the exact Fehlberg 4(5) tableau GSL uses — the reference
delegates to it via ``odeSolveV RKf45`` (``Numeric/Hamilton.hs:445``).  Like
GSL's ``rkf45.c``, the solution is advanced with the 5th-order combination
(local extrapolation) and the embedded 4th-order difference is the error
estimate; the controller order is 5.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["Tableau", "RKF45", "RKCK", "DOPRI5", "RK4", "GAUSS2", "GAUSS4", "GAUSS6"]


@dataclass(frozen=True)
class Tableau:
    """Runge-Kutta tableau.  For embedded pairs, ``b_err = b - b_low`` gives
    the error-estimate combination; ``order`` is the controller order."""

    name: str
    a: Tuple[Tuple[float, ...], ...]  # strictly-lower (explicit) or full (implicit)
    b: Tuple[float, ...]
    c: Tuple[float, ...]
    order: int
    b_err: Optional[Tuple[float, ...]] = None
    implicit: bool = False

    @property
    def stages(self) -> int:
        return len(self.b)


# Fehlberg 4(5) — the GSL ``rkf45`` coefficients. Advance with 5th order;
# error coefficients equal GSL rkf45.c's ``ec[1..6]``.
RKF45 = Tableau(
    name="rkf45",
    c=(0.0, 1.0 / 4.0, 3.0 / 8.0, 12.0 / 13.0, 1.0, 1.0 / 2.0),
    a=(
        (),
        (1.0 / 4.0,),
        (3.0 / 32.0, 9.0 / 32.0),
        (1932.0 / 2197.0, -7200.0 / 2197.0, 7296.0 / 2197.0),
        (439.0 / 216.0, -8.0, 3680.0 / 513.0, -845.0 / 4104.0),
        (-8.0 / 27.0, 2.0, -3544.0 / 2565.0, 1859.0 / 4104.0, -11.0 / 40.0),
    ),
    b=(16.0 / 135.0, 0.0, 6656.0 / 12825.0, 28561.0 / 56430.0, -9.0 / 50.0, 2.0 / 55.0),
    b_err=(
        1.0 / 360.0,
        0.0,
        -128.0 / 4275.0,
        -2197.0 / 75240.0,
        1.0 / 50.0,
        2.0 / 55.0,
    ),
    order=5,
)

# Cash-Karp 4(5) — GSL's ``rkck``.
RKCK = Tableau(
    name="rkck",
    c=(0.0, 1.0 / 5.0, 3.0 / 10.0, 3.0 / 5.0, 1.0, 7.0 / 8.0),
    a=(
        (),
        (1.0 / 5.0,),
        (3.0 / 40.0, 9.0 / 40.0),
        (3.0 / 10.0, -9.0 / 10.0, 6.0 / 5.0),
        (-11.0 / 54.0, 5.0 / 2.0, -70.0 / 27.0, 35.0 / 27.0),
        (
            1631.0 / 55296.0,
            175.0 / 512.0,
            575.0 / 13824.0,
            44275.0 / 110592.0,
            253.0 / 4096.0,
        ),
    ),
    b=(37.0 / 378.0, 0.0, 250.0 / 621.0, 125.0 / 594.0, 0.0, 512.0 / 1771.0),
    b_err=(
        37.0 / 378.0 - 2825.0 / 27648.0,
        0.0,
        250.0 / 621.0 - 18575.0 / 48384.0,
        125.0 / 594.0 - 13525.0 / 55296.0,
        -277.0 / 14336.0,
        512.0 / 1771.0 - 1.0 / 4.0,
    ),
    order=5,
)

# Dormand-Prince 5(4) — scipy's RK45 / MATLAB ode45 tableau.
DOPRI5 = Tableau(
    name="dopri5",
    c=(0.0, 1.0 / 5.0, 3.0 / 10.0, 4.0 / 5.0, 8.0 / 9.0, 1.0, 1.0),
    a=(
        (),
        (1.0 / 5.0,),
        (3.0 / 40.0, 9.0 / 40.0),
        (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
        (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
        (9017.0 / 3168.0, -355.0 / 33.0, 46732.0 / 5247.0, 49.0 / 176.0, -5103.0 / 18656.0),
        (35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0, 11.0 / 84.0),
    ),
    b=(35.0 / 384.0, 0.0, 500.0 / 1113.0, 125.0 / 192.0, -2187.0 / 6784.0, 11.0 / 84.0, 0.0),
    b_err=(
        35.0 / 384.0 - 5179.0 / 57600.0,
        0.0,
        500.0 / 1113.0 - 7571.0 / 16695.0,
        125.0 / 192.0 - 393.0 / 640.0,
        -2187.0 / 6784.0 + 92097.0 / 339200.0,
        11.0 / 84.0 - 187.0 / 2100.0,
        -1.0 / 40.0,
    ),
    order=5,
)

# Classic fixed-step RK4.
RK4 = Tableau(
    name="rk4",
    c=(0.0, 0.5, 0.5, 1.0),
    a=((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
    b=(1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0),
    order=4,
)

_S3 = 3.0**0.5
_S15 = 15.0**0.5

# Gauss-Legendre collocation: symplectic implicit RK of order 2s.
GAUSS2 = Tableau(  # implicit midpoint
    name="gauss2",
    c=(0.5,),
    a=((0.5,),),
    b=(1.0,),
    order=2,
    implicit=True,
)

GAUSS4 = Tableau(
    name="gauss4",
    c=(0.5 - _S3 / 6.0, 0.5 + _S3 / 6.0),
    a=(
        (0.25, 0.25 - _S3 / 6.0),
        (0.25 + _S3 / 6.0, 0.25),
    ),
    b=(0.5, 0.5),
    order=4,
    implicit=True,
)

GAUSS6 = Tableau(
    name="gauss6",
    c=(0.5 - _S15 / 10.0, 0.5, 0.5 + _S15 / 10.0),
    a=(
        (5.0 / 36.0, 2.0 / 9.0 - _S15 / 15.0, 5.0 / 36.0 - _S15 / 30.0),
        (5.0 / 36.0 + _S15 / 24.0, 2.0 / 9.0, 5.0 / 36.0 - _S15 / 24.0),
        (5.0 / 36.0 + _S15 / 30.0, 2.0 / 9.0 + _S15 / 15.0, 5.0 / 36.0),
    ),
    b=(5.0 / 18.0, 4.0 / 9.0, 5.0 / 18.0),
    order=6,
    implicit=True,
)
