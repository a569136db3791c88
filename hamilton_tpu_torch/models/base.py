"""Shared example-system plumbing (counterpart of
:mod:`hamilton_tpu.models.base`)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Tuple

import torch

from hamilton_tpu_torch.mechanics import to_phase
from hamilton_tpu_torch.state import Config, Phase
from hamilton_tpu_torch.system import System

__all__ = ["Example", "logistic"]


@dataclass(frozen=True)
class Example:
    """A packaged demo system: name, coordinate labels, the
    :class:`System`, a draw function mapping underlying Cartesian positions
    to 2-D points, and the initial configuration (on the system's device,
    in its dtype)."""

    name: str
    coord_names: Tuple[str, ...]
    system: System
    draw: Callable[[torch.Tensor], List[torch.Tensor]]  # R^m -> [R^2]
    init_config: Config

    @property
    def init_phase(self) -> Phase:
        """Initial state in phase space: ``to_phase(system, init_config)``."""
        return to_phase(self.system, self.init_config)

    @property
    def n(self) -> int:
        return self.init_config.q.shape[-1]

    @property
    def m(self) -> int:
        return self.system.m


def logistic(pos, ht, width):
    """Soft-wall helper: ``ht / (1 + exp(−β(x − pos)))`` with
    ``β = log(0.9/0.1)/width`` — the reference's smooth barrier used to model
    hard walls as potentials (``app/Examples.hs:601-605``)."""
    beta = math.log(0.9 / (1.0 - 0.9)) / width

    def f(x):
        return ht / (1.0 + torch.exp(-(beta * (x - pos))))

    return f
