"""Auxiliary subsystems (counterpart of :mod:`hamilton_tpu.utils`):
observables (energies, drift, Lyapunov estimates and the streaming
observables of the ensemble drivers), timing on the card, and roofline
accounting with the speed-of-light probes (``profiling``, ``roofline``)."""

from hamilton_tpu_torch.utils.observables import (
    LyapunovPairs,
    PoincareSections,
    RunningExtrema,
    energies,
    energy_drift,
    hamiltonian_trajectory,
    lyapunov_estimate,
)

__all__ = [
    "energies",
    "energy_drift",
    "hamiltonian_trajectory",
    "lyapunov_estimate",
    "LyapunovPairs",
    "RunningExtrema",
    "PoincareSections",
]
