"""Time integrators (counterpart of :mod:`hamilton_tpu.integrators`).

Every integrator of the reference: the fixed-step methods (:mod:`.fixed`:
the Gauss family, ``rk4``, Tao's, the library and fused leapfrog and their
order-4 compositions), the adaptive GSL-parity driver (:mod:`.adaptive`,
over the Butcher tableaus of :mod:`.tableaus`) and the ``evolveHam``
drivers with ``evolve_ham_fixed`` (:mod:`.evolve`).
"""

from hamilton_tpu_torch.integrators.adaptive import (
    ADAPTIVE_METHODS,
    GSL_EPS_DEFAULT,
    embedded_rk_step,
    gsl_evolve_to,
)
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

__all__ = [
    "ADAPTIVE_METHODS",
    "GSL_EPS_DEFAULT",
    "embedded_rk_step",
    "gsl_evolve_to",
    "evolve_ham",
    "evolve_ham_c",
    "evolve_ham_c_list",
    "evolve_ham_fixed",
    "evolve_ham_list",
    "iterate_ham",
    "step_ham",
    "step_ham_c",
    "FIXED_METHODS",
    "Stepper",
    "make_stepper",
]
