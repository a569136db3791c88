"""Bead on an ellipse (counterpart of :mod:`hamilton_tpu.models.ellipse`).

A 1-DOF constrained system: the bead's generalized coordinate is the
ellipse parameter angle, and gravity drives it.  With ``a == b`` it is a
circular pendulum re-parameterized.
"""

from __future__ import annotations

import torch

from hamilton_tpu_torch.models.base import Example
from hamilton_tpu_torch.state import Config
from hamilton_tpu_torch.system import mk_system_cart

__all__ = ["ellipse"]


def ellipse(
    a: float = 2.0,
    b: float = 1.0,
    mass: float = 1.0,
    gravity: float = 5.0,
    theta0: float = 2.0,
    omega0: float = 0.0,
    *,
    device,
    dtype: torch.dtype,
) -> Example:
    """Bead of ``mass`` on an ellipse with semi-axes ``(a, b)``:
    coordinates ``(a·sin θ, b·(1 − cos θ))`` (θ measured from the bottom),
    potential ``U = g·m·y``."""
    params = {"a": a, "b": b, "mass": mass, "gravity": gravity}

    def inertia_fn(p):
        return torch.stack([p["mass"], p["mass"]])

    def coords(q, p):
        th = q[0]
        return torch.stack([
            p["a"].to(q.dtype) * torch.sin(th),
            p["b"].to(q.dtype) * (1.0 - torch.cos(th)),
        ])

    # fused whole-step forms: J = (a·cosθ, b·sinθ)ᵀ gives the 1×1 mass matrix
    # K = m(a²cos²θ + b²sin²θ), ∂T/∂θ|_w = m(b²−a²)·sinθ·cosθ·w², and
    # ∇U = g·m·b·sinθ.  U = g·m·b·(1−cosθ).  Coefficient table:
    # (m·a², m·b², g·m·b, m·(b²−a²)).
    def fused_forms(system):
        from hamilton_tpu_torch.ops.fused_step import (
            FamilyFns, FusedForms, concrete_scalar,
        )

        p = system.params
        vals = [concrete_scalar(p[k]) for k in ("a", "b", "mass", "gravity")]
        consts = None
        if all(v is not None for v in vals):
            a_, b_, m_, g_ = vals
            consts = ((m_ * a_ * a_, m_ * b_ * b_, g_ * m_ * b_,
                       m_ * (b_ * b_ - a_ * a_)),)

        def arrays_fn(dtype, device):
            a_, b_, m_, g_ = (p[k].to(device=device, dtype=dtype)
                              for k in ("a", "b", "mass", "gravity"))
            return (torch.stack([m_ * a_ * a_, m_ * b_ * b_, g_ * m_ * b_,
                                 m_ * (b_ * b_ - a_ * a_)], dim=-1),)

        def make(at, fm):
            ma2 = lambda: at[0](0)  # noqa: E731
            mb2 = lambda: at[0](1)  # noqa: E731
            gmb = lambda: at[0](2)  # noqa: E731
            md = lambda: at[0](3)   # noqa: E731  m(b²−a²)

            def aux(q):
                return (fm.sin(q[0]), fm.cos(q[0]))

            def k_at(aux_v, q):
                s, c = aux_v
                return lambda i, j: ma2() * (c * c) + mb2() * (s * s)

            def dhdq(aux_v, q, w):
                s, c = aux_v
                return [gmb() * s - md() * ((s * c) * (w[0] * w[0]))]

            def potential(aux_v, q):
                _, c = aux_v
                return gmb() * (1.0 - c)

            return FamilyFns(aux, k_at, dhdq, potential)

        return FusedForms(
            n=1, n_aux=2, coef_lens=(4,), consts=consts, make=make,
            name="ellipse", arrays_fn=arrays_fn,
        )

    system = mk_system_cart(
        None,
        coords,
        lambda x, p: (p["gravity"] * p["mass"]).to(x.dtype) * x[1],
        device=device,
        dtype=dtype,
        n=1,
        name="ellipse",
        params=params,
        inertia_fn=inertia_fn,
        fused_forms=fused_forms,
    )

    def draw(xs):
        return [xs]

    return Example(
        name="Bead on ellipse",
        coord_names=("θ",),
        system=system,
        draw=draw,
        init_config=Config(
            torch.tensor([theta0], device=device, dtype=dtype),
            torch.tensor([omega0], device=device, dtype=dtype),
        ),
    )
