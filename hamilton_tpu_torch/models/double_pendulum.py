"""Double pendulum (counterpart of :mod:`hamilton_tpu.models.double_pendulum`).

``System 4 2`` with the second arm half-length; the bob masses live in
``System.params``.
"""

from __future__ import annotations

import math

import torch

from hamilton_tpu_torch.models.base import Example
from hamilton_tpu_torch.state import Config
from hamilton_tpu_torch.system import mk_system_cart

__all__ = ["double_pendulum"]


def double_pendulum(
    m1: float = 1.0, m2: float = 1.0, *, device, dtype: torch.dtype
) -> Example:
    """Double pendulum with bob masses ``m1``, ``m2``: coordinates
    ``(sin θ₁, 1 − cos θ₁, sin θ₁ + sin θ₂ / 2, 1 − cos θ₁ − cos θ₂ / 2)``,
    potential ``U = 5(m₁y₁ + m₂y₂)``, initial state ``q = (π/2, 0)`` at
    rest."""
    params = {"m1": m1, "m2": m2}

    def inertia_fn(p):
        return torch.stack([p["m1"], p["m1"], p["m2"], p["m2"]])

    def coords(q, p):
        t1, t2 = q[0], q[1]
        return torch.stack(
            [
                torch.sin(t1),
                1.0 - torch.cos(t1),
                torch.sin(t1) + torch.sin(t2) / 2.0,
                1.0 - torch.cos(t1) - torch.cos(t2) / 2.0,
            ]
        )

    def potential(x, p):
        return 5.0 * (p["m1"].to(x.dtype) * x[1] + p["m2"].to(x.dtype) * x[3])

    # the fused kernel's view: the planar serial chain with lengths (1, ½)
    # and gravity 5 (the model's constant offset in y₂ does not enter ∇U;
    # the family potential differs from the model's by the constant 2.5·m₂,
    # which cancels in every H−H₀ drift measurement)
    from hamilton_tpu_torch.ops.fused_step import serial_chain_forms

    def fused_forms(system):
        p = system.params
        return serial_chain_forms(
            torch.stack([p["m1"], p["m2"]], dim=-1), [1.0, 0.5], 5.0
        )

    system = mk_system_cart(
        None, coords, potential, device=device, dtype=dtype, n=2,
        name="double_pendulum", fused_forms=fused_forms, params=params,
        inertia_fn=inertia_fn,
    )

    def draw(xs):
        return [xs[0:2], xs[2:4]]

    return Example(
        name="Double pendulum",
        coord_names=("θ1", "θ2"),
        system=system,
        draw=draw,
        init_config=Config(
            torch.tensor([math.pi / 2, 0.0], device=device, dtype=dtype),
            torch.zeros(2, device=device, dtype=dtype),
        ),
    )
