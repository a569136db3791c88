"""The hand-written CUDA kernels themselves (``hamilton_tpu_torch/csrc/
fused_step.cu`` and ``csrc/batched_spd.cu``).

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
from hamilton_tpu_torch.ops import batched_spd as bs
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


# ----------------------------------------------------------------------
# The batched tiny-SPD kernels (K2a-K2e)
# ----------------------------------------------------------------------


def _k2_inputs(card, batch, n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(batch, n, n, generator=g, dtype=torch.float64)
    k = a @ a.mT + n * torch.eye(n, dtype=torch.float64)
    j = 0.3 * torch.randn(batch, 2 * n, n, generator=g, dtype=torch.float64)
    j[:, :n] += torch.eye(n, dtype=torch.float64)
    inertia = 1.0 + torch.rand(2 * n, generator=g, dtype=torch.float64)
    b = torch.randn(batch, n, generator=g, dtype=torch.float64)
    k, j, inertia, b = (t.to(device=card, dtype=dtype) for t in (k, j, inertia, b))
    return k, bs.jac_scaled(j, inertia), b


def _k2_args(entry, k, js, b):
    src = js if entry.from_jac else (bs.cholesky_plain(k) if entry.name == "cho_solve_batched"
                                     else k)
    return (src, b) if entry.solves else (src,)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [3, 20, 32])
@pytest.mark.parametrize("entry", bs.ENTRIES, ids=[e.name for e in bs.ENTRIES])
def test_k2_kernel_matches_plain_version(card, entry, n, dtype):
    """Each entry on a ragged batch of 300 through its public function: one
    launch, and the plain version's result bit for bit (the kernel does the
    same IEEE operations in the same order, none fused)."""
    k, js, b = _k2_inputs(card, 300, n, dtype, seed=n)
    args = _k2_args(entry, k, js, b)
    before = entry.launch.launches
    got = entry.entry(*args)
    assert entry.launch.launches == before + 1
    want = entry.plain(*args)
    assert got.device == card and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_k2_member_that_is_not_spd_gives_nan_there_only(card):
    k, js, b = _k2_inputs(card, 64, 5, torch.float64, seed=1)
    good = bs.spd_solve_batched(k, b)
    bad = k.clone()
    bad[7] = -bad[7]
    for x in (bs.spd_solve_batched(bad, b), bs.cho_solve_batched(bs.cholesky_batched(bad), b)):
        nan = torch.isnan(x).any(-1)
        assert nan.nonzero().flatten().tolist() == [7]
        assert torch.equal(x[~nan], good[~nan])


def test_k2_backward_raises(card):
    k, js, b = _k2_inputs(card, 8, 4, torch.float32, seed=2)
    for out in (bs.spd_solve_batched(k.requires_grad_(True), b),
                bs.cholesky_jac(js.detach().requires_grad_(True))):
        with pytest.raises(NotImplementedError, match="M9"):
            out.sum().backward()
