"""hamilton_tpu_torch — Hamiltonian mechanics in PyTorch, with hand-written
CUDA kernels for an NVIDIA H100.

The PyTorch port of :mod:`hamilton_tpu`, module for module.  Plain tensor
code is PyTorch (``torch.func`` in place of the JAX transforms, Python loops
in place of ``lax`` loops); the fused whole-step leapfrog
(``csrc/fused_step.cu``), the batched tiny-SPD factor and solves of the
library path (``csrc/batched_spd.cu``) and the roofline probes
(``csrc/roofline_probes.cu``) run as CUDA kernels for ``sm_90a`` on CUDA
tensors and as their plain PyTorch versions on CPU tensors.  Ported so far:
the ensemble main path — state, system, mechanics, the serial-chain models,
the library and fused leapfrog with its order-4 compositions and per-member
parameter sweeps, and the final-state ensemble drivers with f64 drift
sampling — the library path: GSL-RKF45 ``evolve_ham`` and its
``stepHam``/``evolveHam`` wrappers — every bundled model (spherical
pendulum, two-body, room, spring, ellipse and Bézier beside the chain) with
its fused forms on the card (``csrc/family_step.cu``), the chain's Möbius
and L⁻¹ forms (``csrc/chain_variants.cu``), the roofline accounting
(``utils.roofline``, ``utils.profiling``), and gradients through all of it:
the fused step (its backward replays the plain version), the K2 entries
(their backwards launch the kernels again) and ``evolve_ham_fixed``; see
``ROADMAP.md`` for what is still to come.  This package never imports JAX.
"""

from hamilton_tpu_torch.convert import params_from_numpy, phase_from_numpy
from hamilton_tpu_torch.ensemble import evolve_ensemble_chunked, evolve_ensemble_final
from hamilton_tpu_torch.integrators.adaptive import GSL_EPS_DEFAULT, gsl_evolve_to
from hamilton_tpu_torch.integrators.evolve import (
    evolve_ham,
    evolve_ham_c,
    evolve_ham_c_list,
    evolve_ham_fixed,
    evolve_ham_list,
    iterate_ham,
    step_ham,
    step_ham_c,
)
from hamilton_tpu_torch.integrators.fixed import FIXED_METHODS, Stepper, make_stepper
from hamilton_tpu_torch.mechanics import (
    QFactor,
    dhdp_factored,
    dhdq_factored,
    from_phase,
    ham_eqs,
    ham_rhs,
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
from hamilton_tpu_torch.models import (
    DEFAULT_POINTS,
    REGISTRY,
    Example,
    bezier,
    bezier_curve,
    chain,
    double_pendulum,
    ellipse,
    get_example,
    pendulum,
    room,
    spherical_pendulum,
    spring,
    two_body,
)
from hamilton_tpu_torch.ops.fused_step import (
    FusedForms,
    FamilyFns,
    fused_step_reference,
    fused_stepper,
    serial_chain_forms,
    serial_chain_forms_linv,
    serial_chain_forms_mobius,
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
    "ham_rhs",
    "QFactor",
    "q_factor",
    "dhdp_factored",
    "dhdq_factored",
    "Example",
    "chain",
    "double_pendulum",
    "pendulum",
    "spring",
    "room",
    "two_body",
    "spherical_pendulum",
    "ellipse",
    "bezier",
    "bezier_curve",
    "DEFAULT_POINTS",
    "REGISTRY",
    "get_example",
    "GSL_EPS_DEFAULT",
    "gsl_evolve_to",
    "evolve_ham",
    "evolve_ham_list",
    "evolve_ham_fixed",
    "step_ham",
    "iterate_ham",
    "step_ham_c",
    "evolve_ham_c",
    "evolve_ham_c_list",
    "Stepper",
    "make_stepper",
    "FIXED_METHODS",
    "FusedForms",
    "FamilyFns",
    "fused_stepper",
    "fused_step_reference",
    "serial_chain_forms",
    "serial_chain_forms_on",
    "serial_chain_forms_mobius",
    "serial_chain_forms_linv",
    "evolve_ensemble_final",
    "evolve_ensemble_chunked",
    "params_from_numpy",
    "phase_from_numpy",
]
