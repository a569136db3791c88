"""Spherical pendulum (counterpart of :mod:`hamilton_tpu.models.spherical`).

A 3-D Cartesian system, ``System 3 2``, with coordinates on the unit sphere,

    f(θ, φ) = (sin θ cos φ, sin θ sin φ, 1 − cos θ),

θ from the downward vertical, φ azimuthal.  ``U = g·m·z``.  The azimuthal
momentum ``p_φ`` is exactly conserved.
"""

from __future__ import annotations

import torch

from hamilton_tpu_torch.models.base import Example
from hamilton_tpu_torch.state import Config
from hamilton_tpu_torch.system import mk_system_cart

__all__ = ["spherical_pendulum"]


def spherical_pendulum(
    mass: float = 1.0,
    gravity: float = 5.0,
    theta0: float = 1.0,
    phi_dot0: float = 1.0,
    *,
    device,
    dtype: torch.dtype,
) -> Example:
    """Pendulum bob free to swing in 3-D on a unit rod, starting at
    θ₀ = ``theta0`` with azimuthal rate ``phi_dot0``: a precessing orbit
    between two polar circles."""
    params = {"mass": mass, "gravity": gravity}

    def inertia_fn(p):
        return torch.stack([p["mass"], p["mass"], p["mass"]])

    def coords(q, p):
        th, ph = q[0], q[1]
        s = torch.sin(th)
        return torch.stack([s * torch.cos(ph), s * torch.sin(ph), 1.0 - torch.cos(th)])

    # fused whole-step forms: the sphere map's mass matrix is diagonal,
    # K = diag(m, m·sin²θ), with ∂H/∂θ = g·m·sinθ − m·sinθ·cosθ·w_φ² and
    # ∂H/∂φ = 0 (exact in the closed forms).  U = g·m·(1−cosθ) equals the
    # model's Cartesian potential.  Singular at the poles (sinθ = 0), as the
    # library path is.
    def fused_forms(system):
        from hamilton_tpu_torch.ops.fused_step import (
            FamilyFns, FusedForms, concrete_scalar,
        )

        p = system.params
        m_c = concrete_scalar(p["mass"])
        g_c = concrete_scalar(p["gravity"])
        consts = None
        if m_c is not None and g_c is not None:
            consts = ((m_c, g_c * m_c),)

        def arrays_fn(dtype, device):
            m_ = p["mass"].to(device=device, dtype=dtype)
            g_ = p["gravity"].to(device=device, dtype=dtype)
            return (torch.stack([m_, g_ * m_], dim=-1),)

        def make(at, fm):
            mass = lambda: at[0](0)  # noqa: E731
            gm = lambda: at[0](1)    # noqa: E731  g·m

            def aux(q):
                return (fm.sin(q[0]), fm.cos(q[0]))

            def k_at(aux_v, q):
                s, _ = aux_v

                def at_(i, j):
                    if (i, j) == (0, 0):
                        return fm.full(mass(), s)
                    if (i, j) == (1, 1):
                        return mass() * (s * s)
                    return fm.zero(s)

                return at_

            def dhdq(aux_v, q, w):
                s, c = aux_v
                return [
                    gm() * s - mass() * (s * c) * (w[1] * w[1]),
                    fm.zero(s),
                ]

            def potential(aux_v, q):
                _, c = aux_v
                return gm() * (1.0 - c)

            return FamilyFns(aux, k_at, dhdq, potential)

        return FusedForms(
            n=2, n_aux=2, coef_lens=(2,), consts=consts, make=make,
            name="spherical_pendulum", arrays_fn=arrays_fn,
        )

    system = mk_system_cart(
        None,
        coords,
        lambda x, p: (p["gravity"] * p["mass"]).to(x.dtype) * x[2],
        device=device,
        dtype=dtype,
        n=2,
        name="spherical_pendulum",
        params=params,
        inertia_fn=inertia_fn,
        fused_forms=fused_forms,
    )

    def draw(xs):
        # project onto the (x, z) plane for the 2-D terminal plotter
        return [torch.stack([xs[0], xs[2]])]

    return Example(
        name="Spherical pendulum",
        coord_names=("θ", "φ"),
        system=system,
        draw=draw,
        init_config=Config(
            torch.tensor([theta0, 0.0], device=device, dtype=dtype),
            torch.tensor([0.0, phi_dot0], device=device, dtype=dtype),
        ),
    )
