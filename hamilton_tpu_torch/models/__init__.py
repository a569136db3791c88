"""Example physical systems (counterpart of :mod:`hamilton_tpu.models`).

Ported so far: the serial-chain members that the ensemble main path runs,
and the spring (the library path's model without an analytic mass matrix).
The room, two-body, Bézier, ellipse and spherical-pendulum models are
ROADMAP M9.
"""

from hamilton_tpu_torch.models.base import Example, logistic
from hamilton_tpu_torch.models.chain import chain
from hamilton_tpu_torch.models.double_pendulum import double_pendulum
from hamilton_tpu_torch.models.pendulum import pendulum
from hamilton_tpu_torch.models.spring import spring

__all__ = ["Example", "logistic", "chain", "double_pendulum", "pendulum", "spring"]
