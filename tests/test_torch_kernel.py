"""The hand-written CUDA kernel itself (``hamilton_tpu_torch/csrc/fused_step.cu``).

These tests need an NVIDIA card and nvcc; elsewhere they skip.  This file
imports no JAX, so on a machine without it run it without the suite's
conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernel.py
"""

import numpy as np
import pytest
import torch

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import kernels
from hamilton_tpu_torch.ops import fused_step as t_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _state(ex, iters, compensated, batch, card, seed=0):
    rng = np.random.default_rng(seed)
    n = ex.n
    q = ex.init_config.q.cpu().numpy() + 0.01 * rng.standard_normal((batch, n))
    p = 0.05 * rng.standard_normal((batch, n))
    forms = ex.system.fused_forms(ex.system)
    st = t_step.fused_stepper(forms, iters=iters, compensated=compensated)
    return forms, st.init(tp.phase_from_numpy(q, p, device=card, dtype=torch.float64))


@pytest.mark.parametrize("case", ["chain20-semiseparable-2-0-kahan", "double_pendulum-dense-2-1"])
def test_kernel_matches_plain_version(card, case):
    """float64, a ragged batch, ten steps per launch: the kernel's state
    agrees with its plain version to float64 rounding (vdot_est compared as
    dt·vdot_est, the velocity difference it is computed from)."""
    if case.startswith("chain20"):
        ex = tp.chain(n_links=20, fused_solver="semiseparable", device=card,
                      dtype=torch.float64)
        iters, comp, dt = (2, 0), True, 5e-4
    else:
        ex = tp.double_pendulum(device=card, dtype=torch.float64)
        iters, comp, dt = (2, 1), False, 1e-3
    forms, state = _state(ex, iters, comp, 300, card)
    before = kernels.fused_step_launch.launches
    got = t_step.fused_step_kernel(forms, state, dt, iters=iters, compensated=comp,
                                   steps_per_call=10)
    assert kernels.fused_step_launch.launches == before + 1
    want = t_step.fused_step_reference(forms, state, dt, iters=iters, compensated=comp,
                                       steps_per_call=10)
    scale = torch.ones(state.shape[0], 1, 1, dtype=torch.float64, device=card)
    scale[-1] = dt
    assert float(((got - want) * scale).abs().max()) < 1e-11


def test_kernel_matches_library_leapfrog(card):
    ex = tp.chain(n_links=5, fused_solver="semiseparable", device=card, dtype=torch.float64)
    rng = np.random.default_rng(1)
    q = 0.5 + 0.01 * rng.standard_normal((100, 5))
    p = 0.05 * rng.standard_normal((100, 5))
    ph = tp.phase_from_numpy(q, p, device=card, dtype=torch.float64)
    lib = tp.make_stepper(ex.system, "leapfrog", iters=(3, 2))
    fus = tp.make_stepper(ex.system, "leapfrog_fused", iters=(3, 2))
    dt = torch.tensor(1e-3, dtype=torch.float64)
    cl, cf = lib.init(ph), fus.init(ph)
    for _ in range(2):
        cl, cf = lib.step(cl, dt), fus.step(cf, dt)
    a, b = lib.extract(cl), fus.extract(cf)
    assert float((a.q - b.q).abs().max()) < 1e-12
    assert float((a.p - b.p).abs().max()) < 1e-12


def test_uninstantiated_size_raises_on_the_card(card):
    ex = tp.chain(n_links=7, fused_solver="semiseparable", device=card, dtype=torch.float32)
    st = tp.make_stepper(ex.system, "leapfrog_fused", iters=(2, 0))
    carry = st.init(tp.Phase(ex.init_config.q.expand(4, 7).contiguous(),
                             torch.zeros(4, 7, device=card)))
    with pytest.raises(ValueError, match="instantiated"):
        st.step(carry, 1e-3)
