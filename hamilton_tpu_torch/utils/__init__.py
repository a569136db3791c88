"""Auxiliary subsystems (counterpart of :mod:`hamilton_tpu.utils`):
observables (energies, drift, Lyapunov estimates and the streaming
observables of the ensemble drivers), checkpointing, diagnostics (NaN and
energy sentinels), Poincaré sections, timing on the card, and roofline
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
from hamilton_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_orbax,
    save_checkpoint,
    save_orbax,
)
from hamilton_tpu_torch.utils.diagnostics import check_finite_phase, checked, nan_guard
from hamilton_tpu_torch.utils.poincare import coordinate_section, poincare_section
from hamilton_tpu_torch.utils.profiling import benchmark_fn

__all__ = [
    "energies",
    "energy_drift",
    "hamiltonian_trajectory",
    "lyapunov_estimate",
    "save_checkpoint",
    "load_checkpoint",
    "save_orbax",
    "load_orbax",
    "check_finite_phase",
    "checked",
    "nan_guard",
    "benchmark_fn",
    "poincare_section",
    "coordinate_section",
    "LyapunovPairs",
    "RunningExtrema",
    "PoincareSections",
]
