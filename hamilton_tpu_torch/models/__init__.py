"""Example physical systems (counterpart of :mod:`hamilton_tpu.models`).

Ported so far: the serial-chain members that the ensemble main path runs.
The room, two-body, spring, Bézier, ellipse and spherical-pendulum models
are ROADMAP M9.
"""

from hamilton_tpu_torch.models.base import Example
from hamilton_tpu_torch.models.chain import chain
from hamilton_tpu_torch.models.double_pendulum import double_pendulum
from hamilton_tpu_torch.models.pendulum import pendulum

__all__ = ["Example", "chain", "double_pendulum", "pendulum"]
