"""Configuration-space and phase-space state records.

PyTorch counterpart of :mod:`hamilton_tpu.state`: frozen dataclasses of
tensors whose trailing axis is the ``n`` generalized coordinates and whose
leading axes (if any) are batch axes — an ensemble is ``(B, n)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Config", "Phase"]


def _check_pair(kind: str, a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.shape != b.shape:
        raise ValueError(
            f"{kind} positions/{what} shape mismatch: "
            f"{tuple(a.shape)} vs {tuple(b.shape)}"
        )


@dataclass(frozen=True)
class Config:
    """State in configuration space: positions ``q`` and velocities ``v``."""

    q: torch.Tensor
    v: torch.Tensor

    def __post_init__(self):
        _check_pair("Config", self.q, self.v, "velocities")

    @property
    def positions(self) -> torch.Tensor:
        return self.q

    @property
    def velocities(self) -> torch.Tensor:
        return self.v

    @property
    def n(self) -> int:
        """Number of generalized coordinates (the trailing axis size)."""
        return self.q.shape[-1]

    def astype(self, dtype: torch.dtype) -> "Config":
        return Config(self.q.to(dtype), self.v.to(dtype))


@dataclass(frozen=True)
class Phase:
    """State in phase space: positions ``q`` and conjugate momenta ``p`` —
    the working state of every integrator."""

    q: torch.Tensor
    p: torch.Tensor

    def __post_init__(self):
        _check_pair("Phase", self.q, self.p, "momenta")

    @property
    def positions(self) -> torch.Tensor:
        return self.q

    @property
    def momenta(self) -> torch.Tensor:
        return self.p

    @property
    def n(self) -> int:
        """Number of generalized coordinates (the trailing axis size)."""
        return self.q.shape[-1]

    def astype(self, dtype: torch.dtype) -> "Phase":
        return Phase(self.q.to(dtype), self.p.to(dtype))

    def flatten(self) -> torch.Tensor:
        """Pack into a flat ``(..., 2n)`` vector ``[q, p]``."""
        return torch.cat([self.q, self.p], dim=-1)

    @staticmethod
    def unflatten(y: torch.Tensor) -> "Phase":
        """Inverse of :meth:`flatten`."""
        n = y.shape[-1] // 2
        return Phase(y[..., :n], y[..., n:])
