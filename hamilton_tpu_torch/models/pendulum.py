"""Single pendulum (counterpart of :mod:`hamilton_tpu.models.pendulum`)."""

from __future__ import annotations

import torch

from hamilton_tpu_torch.models.base import Example
from hamilton_tpu_torch.state import Config
from hamilton_tpu_torch.system import mk_system_cart

__all__ = ["pendulum"]


def pendulum(
    theta0: float = 0.0, omega0: float = 1.0, *, device, dtype: torch.dtype
) -> Example:
    """Pendulum bob at angle θ: ``System 2 1``, coordinates
    ``(sin θ, 0.5 − cos θ)``, unit masses, gravity potential ``U = y``."""
    # the fused kernel's view: the n=1 planar serial chain (the family
    # potential differs from the model's by the constant −0.5)
    from hamilton_tpu_torch.ops.fused_step import serial_chain_forms

    system = mk_system_cart(
        [1.0, 1.0],
        lambda q: torch.stack([torch.sin(q[0]), 0.5 - torch.cos(q[0])]),
        lambda x: x[1],
        device=device,
        dtype=dtype,
        n=1,
        name="pendulum",
        fused_forms=lambda system: serial_chain_forms([1.0], [1.0], 1.0),
    )

    def draw(xs):
        return [xs]

    return Example(
        name="Single pendulum",
        coord_names=("θ",),
        system=system,
        draw=draw,
        init_config=Config(
            torch.tensor([theta0], device=device, dtype=dtype),
            torch.tensor([omega0], device=device, dtype=dtype),
        ),
    )
