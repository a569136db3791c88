"""hamilton_tpu_torch — Hamiltonian mechanics in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100.

The PyTorch port of :mod:`hamilton_tpu`, module for module.  Plain tensor
code is PyTorch (``torch.func`` in place of the JAX transforms, Python loops
in place of ``lax`` loops); the fused whole-step leapfrog runs as a CUDA
kernel for ``sm_90a`` (``csrc/fused_step.cu``) on CUDA tensors and as its
plain PyTorch version on CPU tensors.  Ported so far: the ensemble main
path — state, system, mechanics, the serial-chain models, the library and
fused leapfrog, and the final-state ensemble drivers with f64 drift
sampling (see ``ROADMAP.md`` for what is still to come).  This package
never imports JAX.
"""

from hamilton_tpu_torch.convert import params_from_numpy, phase_from_numpy
from hamilton_tpu_torch.ensemble import evolve_ensemble_chunked, evolve_ensemble_final
from hamilton_tpu_torch.integrators.fixed import FIXED_METHODS, Stepper, make_stepper
from hamilton_tpu_torch.mechanics import (
    QFactor,
    dhdp_factored,
    dhdq_factored,
    from_phase,
    ham_eqs,
    hamiltonian,
    ke_c,
    ke_p,
    lagrangian,
    mass_matrix,
    momenta,
    pe,
    q_factor,
    to_phase,
    velocities,
)
from hamilton_tpu_torch.models import Example, chain, double_pendulum, pendulum
from hamilton_tpu_torch.ops.fused_step import (
    FusedForms,
    FamilyFns,
    fused_step_reference,
    fused_stepper,
    serial_chain_forms,
    serial_chain_forms_on,
)
from hamilton_tpu_torch.state import Config, Phase
from hamilton_tpu_torch.system import System, mk_system, mk_system_cart, underlying_pos

__all__ = [
    "Config",
    "Phase",
    "System",
    "mk_system",
    "mk_system_cart",
    "underlying_pos",
    "mass_matrix",
    "momenta",
    "velocities",
    "to_phase",
    "from_phase",
    "pe",
    "ke_c",
    "ke_p",
    "lagrangian",
    "hamiltonian",
    "ham_eqs",
    "QFactor",
    "q_factor",
    "dhdp_factored",
    "dhdq_factored",
    "Example",
    "chain",
    "double_pendulum",
    "pendulum",
    "Stepper",
    "make_stepper",
    "FIXED_METHODS",
    "FusedForms",
    "FamilyFns",
    "fused_stepper",
    "fused_step_reference",
    "serial_chain_forms",
    "serial_chain_forms_on",
    "evolve_ensemble_final",
    "evolve_ensemble_chunked",
    "params_from_numpy",
    "phase_from_numpy",
]
