"""Bead on a Bézier curve (counterpart of :mod:`hamilton_tpu.models.bezier`,
reference ``bezier``, ``app/Examples.hs:164-183``).

A 1-DOF system whose generalized coordinate is the curve parameter ``t``;
the curve's degree is set by the number of control points.
"""

from __future__ import annotations

import math
from math import comb
from typing import Sequence, Tuple

import torch

from hamilton_tpu_torch.models.base import Example, logistic
from hamilton_tpu_torch.state import Config
from hamilton_tpu_torch.system import mk_system

__all__ = ["bezier", "bezier_curve", "DEFAULT_POINTS"]

#: Reference CLI default control points (``app/Examples.hs:350``).
DEFAULT_POINTS: Tuple[Tuple[float, float], ...] = (
    (-1.0, -1.0),
    (-2.0, 1.0),
    (0.0, 1.0),
    (1.0, -1.0),
    (2.0, 1.0),
)

# the parameter-clamp walls' logistic steepness β = log 9 / width and height
_WB = math.log(9.0) / 0.05
_WH = 5.0


def bezier_curve(points: torch.Tensor, t) -> torch.Tensor:
    """The Bernstein-basis Bézier curve at parameter ``t``:
    ``B(t) = Σ_i C(n,i)·(1−t)^(n−i)·t^i·P_i`` with ``n = len(points)−1``;
    ``points`` is a ``(k, 2)`` tensor and ``t`` a tensor or a float."""
    n = points.shape[0] - 1
    acc = torch.zeros(points.shape[1:], dtype=points.dtype, device=points.device)
    for i in range(n + 1):
        acc = acc + comb(n, i) * (1.0 - t) ** (n - i) * t**i * points[i]
    return acc


def _deriv_tables(arr: torch.Tensor, deg: int) -> torch.Tensor:
    """``(…, k, 2)`` control points → the flat ``(…, 2(k−1) [+ 2(k−2)])``
    first- and second-derivative control points."""
    d1 = deg * (arr[..., 1:, :] - arr[..., :-1, :])
    flat1 = d1.reshape(d1.shape[:-2] + (2 * deg,))
    if deg >= 2:
        d2 = (deg - 1) * (d1[..., 1:, :] - d1[..., :-1, :])
        flat2 = d2.reshape(d2.shape[:-2] + (2 * (deg - 1),))
        return torch.cat([flat1, flat2], dim=-1)
    return flat1


def _binomials(deg: int) -> Tuple[int, ...]:
    """The Bernstein binomial of each table entry: ``C(deg−1, i)`` for the
    first-derivative points, ``C(deg−2, i)`` for the second's, two entries
    (x, y) a point."""
    first = tuple(comb(deg - 1, k // 2) for k in range(2 * deg))
    if deg < 2:
        return first
    return first + tuple(comb(deg - 2, k // 2) for k in range(2 * (deg - 1)))


def bezier(
    points: Sequence[Tuple[float, float]] = DEFAULT_POINTS, *, device, dtype: torch.dtype
) -> Example:
    """Particle on a Bézier curve with parameter-clamp logistic walls at
    ``t = 0`` and ``t = 1``.  Initial state ``t = 0.5``, ``ṫ = 0.25``."""
    pts = torch.as_tensor(points, device=device, dtype=dtype)
    if pts.ndim != 2 or pts.shape[0] < 1 or pts.shape[1] != 2:
        raise ValueError(
            f"bezier requires a (k, 2) control-point array with k >= 1, "
            f"got shape {tuple(pts.shape)}"
        )
    left = logistic(0.0, 5.0, 0.05)
    right = logistic(1.0, 5.0, 0.05)
    # the control points are the model's physics parameters (sweepable like
    # every other parameter)
    params = {"points": pts}

    def coords(q, p):
        return bezier_curve(p["points"].to(q.dtype), q[0])

    def potential(q, p):
        t = q[0]
        return (1.0 - left(t)) + right(t)

    # fused whole-step forms: with unit masses the 1×1 mass matrix is
    # K(t) = x'(t)² + y'(t)² and ∂T/∂t|_w = (x'x'' + y'y'')·w², with the
    # derivative curves in degree-reduced Bernstein form; ∇U is the walls'
    # logistic derivative.  Coefficient table: the flattened first- and
    # second-derivative control points.  Needs k ≥ 2 control points (k = 1
    # has B' ≡ 0: K is singular).
    k_pts = int(pts.shape[0])

    def fused_forms(system):
        from hamilton_tpu_torch.ops.fused_step import FamilyFns, FusedForms

        pp = system.params["points"]
        deg = k_pts - 1
        consts = kernel_consts = None
        if pp.ndim == 2 and not pp.requires_grad:
            flat = tuple(float(v) for v in _deriv_tables(pp, deg).tolist())
            consts = (flat,)
            # the shared path folds each binomial into its entry in double
            # (``fm.full(c * v, t)`` below): the kernel's table holds the
            # folded entries
            kernel_consts = tuple(float(c) * v for c, v in zip(_binomials(deg), flat))

        table_len = 2 * deg + (2 * (deg - 1) if deg >= 2 else 0)

        def arrays_fn(dtype, device):
            return (_deriv_tables(pp.to(device=device, dtype=dtype), deg),)

        def make(at, fm):
            def bernstein(t, one_t, d, base):
                """Σ C(d,i)(1−t)^{d−i} t^i · (x_i, y_i) from table entries
                ``base + 2i`` / ``base + 2i + 1``."""
                # power lists built once per evaluation point
                tp = [None] * (d + 1)
                up = [None] * (d + 1)
                cur = t
                for i in range(1, d + 1):
                    tp[i] = cur
                    cur = cur * t
                cur = one_t
                for i in range(1, d + 1):
                    up[i] = cur
                    cur = cur * one_t

                def term(i, off):
                    v = at[0](base + 2 * i + off)
                    c = float(comb(d, i))
                    if isinstance(v, (int, float)):
                        w = fm.full(c * v, t)  # value-typed from the start
                    else:
                        w = c * v
                    if i > 0:
                        w = w * tp[i]
                    if d - i > 0:
                        w = w * up[d - i]
                    return w

                x = term(0, 0)
                y = term(0, 1)
                for i in range(1, d + 1):
                    x = x + term(i, 0)
                    y = y + term(i, 1)
                return x, y

            def aux(q):
                t = q[0]
                one_t = 1.0 - t
                xp, yp = bernstein(t, one_t, deg - 1, 0)
                if deg >= 2:
                    xpp, ypp = bernstein(t, one_t, deg - 2, 2 * deg)
                else:
                    xpp, ypp = fm.zero(t), fm.zero(t)
                return (xp, yp, xpp, ypp)

            def k_at(aux_v, q):
                xp, yp, _, _ = aux_v
                return lambda i, j: xp * xp + yp * yp

            def sigma(z):
                return 1.0 / (1.0 + fm.exp(0.0 - z))

            def dhdq(aux_v, q, w):
                xp, yp, xpp, ypp = aux_v
                sl = sigma(_WB * q[0])
                sr = sigma(_WB * (q[0] - 1.0))
                hb = _WH * _WB
                du = hb * (sr * (1.0 - sr)) - hb * (sl * (1.0 - sl))
                return [du - (xp * xpp + yp * ypp) * (w[0] * w[0])]

            def potential(aux_v, q):
                lft = _WH * sigma(_WB * q[0])
                rgt = _WH * sigma(_WB * (q[0] - 1.0))
                return (1.0 - lft) + rgt

            return FamilyFns(aux, k_at, dhdq, potential)

        return FusedForms(
            n=1, n_aux=4, coef_lens=(table_len,), consts=consts, make=make,
            name="bezier", arrays_fn=arrays_fn, kernel_consts=kernel_consts,
            runtime_shared=False,
        )

    system = mk_system(
        [1.0, 1.0], coords, potential, device=device, dtype=dtype, n=1, name="bezier",
        params=params, fused_forms=fused_forms if k_pts >= 2 else None,
    )

    def draw(xs):
        return [xs]

    return Example(
        name="Bezier",
        coord_names=("t",),
        system=system,
        draw=draw,
        init_config=Config(
            torch.tensor([0.5], device=device, dtype=dtype),
            torch.tensor([0.25], device=device, dtype=dtype),
        ),
    )
