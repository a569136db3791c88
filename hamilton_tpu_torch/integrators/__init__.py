"""Time integrators (counterpart of :mod:`hamilton_tpu.integrators`).

Ported so far: the fixed-step leapfrog family in :mod:`.fixed`.  The
adaptive GSL-parity drivers and ``evolve.py`` are ROADMAP M11.
"""

from hamilton_tpu_torch.integrators.fixed import FIXED_METHODS, Stepper, make_stepper

__all__ = ["FIXED_METHODS", "Stepper", "make_stepper"]
