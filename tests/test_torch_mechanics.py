"""Parity of the PyTorch port's mechanics with the JAX package, in float64.

The same inputs, made with numpy from a seed, go through ``hamilton_tpu``
and ``hamilton_tpu_torch``; the physical parameters are carried across with
``params_from_numpy``.  Both sides evaluate the same formulas with
linear-algebra routines that round differently (the reference's unrolled or
masked Cholesky on ``K = JᵀMJ`` against the port's batched entries, which on
the spring form K from ``√M·J``), so they agree to float64 rounding:
``atol=1e-12``.  The spring is the J-route model: no analytic Jacobian or
mass matrix, so its batched solves and factors go through K2d and K2e.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamilton_tpu import mechanics as jmech
from hamilton_tpu import models as jmodels
from hamilton_tpu.integrators.fixed import make_stepper as j_make_stepper
from hamilton_tpu.state import Phase as JPhase

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import mechanics as tmech
from hamilton_tpu_torch.convert import params_from_numpy, phase_from_numpy

F64 = torch.float64
ATOL = 1e-12
B = 16

# name → (JAX example, port example factory); the chain has non-uniform
# masses and lengths so that the carried-over params matter
MODELS = {
    "chain5": (
        lambda: jmodels.chain(n_links=5, masses=[1.3, 0.7, 1.1, 0.9, 1.6],
                              link_length=0.8),
        lambda: tp.chain(n_links=5, device="cpu", dtype=F64),
    ),
    "double_pendulum": (
        lambda: jmodels.double_pendulum(m1=1.3, m2=0.7),
        lambda: tp.double_pendulum(device="cpu", dtype=F64),
    ),
    "pendulum": (
        lambda: jmodels.pendulum(),
        lambda: tp.pendulum(device="cpu", dtype=F64),
    ),
    "spring": (
        lambda: jmodels.spring(m_block=1.7, m_weight=0.8, k=12.0),
        lambda: tp.spring(device="cpu", dtype=F64),
    ),
}


def _pair(name):
    jex = MODELS[name][0]()
    tsys = MODELS[name][1]().system
    if jex.system.params is not None:
        tsys = tsys.replace_params(params_from_numpy(
            {k: np.asarray(v) for k, v in jex.system.params.items()},
            device="cpu", dtype=F64,
        ))
    return jex.system, tsys


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.5, 1.5, (B, n))
    p = rng.standard_normal((B, n))
    w = rng.standard_normal((B, n))
    return q, p, w


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=0, atol=atol)


@pytest.fixture(params=sorted(MODELS))
def case(request):
    jsys, tsys = _pair(request.param)
    n = {"chain5": 5, "double_pendulum": 2, "pendulum": 1, "spring": 3}[request.param]
    q, p, w = _inputs(n)
    return jsys, tsys, q, p, w


def test_jacobian(case):
    jsys, tsys, q, _, _ = case
    _close(jmech._jacobian(jsys, jnp.asarray(q)),
           tmech._jacobian(tsys, torch.as_tensor(q)))


def test_coords_hessian(case):
    """∂J/∂q of one member (the rank-3 Hessian of the coordinate map)."""
    jsys, tsys, q, _, _ = case
    _close(jsys.hessian(jnp.asarray(q[0])), tsys.hessian(torch.as_tensor(q[0])))


def test_mass_matrix(case):
    jsys, tsys, q, _, _ = case
    _close(jmech.mass_matrix(jsys, jnp.asarray(q)),
           tmech.mass_matrix(tsys, torch.as_tensor(q)))


def test_potential_grad(case):
    jsys, tsys, q, _, _ = case
    _close(jmech._grad_u(jsys, jnp.asarray(q)),
           tmech._grad_u(tsys, torch.as_tensor(q)))


def test_velocities(case):
    jsys, tsys, q, p, _ = case
    _close(jmech.velocities(jsys, JPhase(jnp.asarray(q), jnp.asarray(p))),
           tmech.velocities(tsys, phase_from_numpy(q, p, device="cpu", dtype=F64)))


def test_hamiltonian(case):
    jsys, tsys, q, p, _ = case
    _close(jmech.hamiltonian(jsys, JPhase(jnp.asarray(q), jnp.asarray(p))),
           tmech.hamiltonian(tsys, phase_from_numpy(q, p, device="cpu", dtype=F64)))


def test_dtdq(case):
    """The kinetic part of ∂H/∂q by the VJP-of-JVP sweep."""
    jsys, tsys, q, _, w = case
    _close(jmech._dtdq(jsys, jnp.asarray(q), jnp.asarray(w)),
           tmech._dtdq(tsys, torch.as_tensor(q), torch.as_tensor(w)))


def test_q_factor_and_factored_derivatives(case):
    jsys, tsys, q, p, _ = case
    jf = jmech.q_factor(jsys, jnp.asarray(q))
    tf = tmech.q_factor(tsys, torch.as_tensor(q))
    _close(jf.chol, tf.chol)
    _close(jf.grad_u, tf.grad_u)
    _close(jmech.dhdp_factored(jf, jnp.asarray(p)),
           tmech.dhdp_factored(tf, torch.as_tensor(p)))
    _close(jmech.dhdq_factored(jsys, jf, jnp.asarray(q), jnp.asarray(p)),
           tmech.dhdq_factored(tsys, tf, torch.as_tensor(q), torch.as_tensor(p)))


def test_ham_eqs_and_phase_round_trip(case):
    jsys, tsys, q, p, _ = case
    jdq, jdp = jmech.ham_eqs(jsys, JPhase(jnp.asarray(q), jnp.asarray(p)))
    tph = phase_from_numpy(q, p, device="cpu", dtype=F64)
    tdq, tdp = tmech.ham_eqs(tsys, tph)
    _close(jdq, tdq)
    _close(jdp, tdp)
    back = tmech.to_phase(tsys, tmech.from_phase(tsys, tph))
    np.testing.assert_allclose(back.p.numpy(), p, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["double_pendulum", "spring"])
def test_to_phase_float32_matches_reference(name):
    """In float32 the maps that divide a 0-d value by a Python float (the
    double pendulum's, the spring's) give float32 Jacobians and momenta, as
    ``jax.jacfwd`` does; the values agree with the JAX package's float32 to a
    few float32 ulps of |p|."""
    jsys, _ = _pair(name)
    jsys32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jsys)
    tsys32 = MODELS[name][1]().system.replace_params(params_from_numpy(
        {k: np.asarray(v) for k, v in jsys.params.items()},
        device="cpu", dtype=torch.float32,
    ))
    n = {"double_pendulum": 2, "spring": 3}[name]
    q, v, _ = _inputs(n, seed=4)
    q, v = q.astype(np.float32), v.astype(np.float32)
    jph = jmech.to_phase(jsys32, jmech.Config(jnp.asarray(q), jnp.asarray(v)))
    tph = tmech.to_phase(tsys32, tp.Config(torch.as_tensor(q), torch.as_tensor(v)))
    assert jph.p.dtype == jnp.float32
    assert tph.p.dtype == torch.float32 and tph.q.dtype == torch.float32
    assert tsys32.jacobian(torch.as_tensor(q[0])).dtype == torch.float32
    assert tsys32.hessian(torch.as_tensor(q[0])).dtype == torch.float32
    scale = float(np.abs(np.asarray(jph.p)).max())
    _close(jph.p, tph.p, atol=8 * np.finfo(np.float32).eps * scale)
    st = tp.make_stepper(tsys32, "leapfrog_fused" if name == "double_pendulum"
                         else "leapfrog", iters=(2, 1))
    assert st.extract(st.init(tph)).p.dtype == torch.float32


@pytest.mark.parametrize("iters,compensated", [((3, 1), False), ((2, 0), True)],
                         ids=["exact-3-1", "gauss-seidel-2-0-kahan"])
def test_library_leapfrog_matches_reference(case, iters, compensated):
    """Two steps of the port's library leapfrog against the reference's,
    in both q-refinement modes."""
    jsys, tsys, q, p, _ = case
    q, p = 0.3 * q, 0.1 * p
    jst = j_make_stepper(jsys, "leapfrog", iters=iters, compensated=compensated)
    tst = tp.make_stepper(tsys, "leapfrog", iters=iters, compensated=compensated)
    jc = jst.init(JPhase(jnp.asarray(q), jnp.asarray(p)))
    tc = tst.init(phase_from_numpy(q, p, device="cpu", dtype=F64))
    jdt, tdt = jnp.float64(1e-3), torch.tensor(1e-3, dtype=F64)
    jstep = jax.jit(jst.step)  # one compile instead of slow eager dispatch
    for _ in range(2):
        jc, tc = jstep(jc, jdt), tst.step(tc, tdt)
    ja, ta = jst.extract(jc), tst.extract(tc)
    _close(ja.q, ta.q)
    _close(ja.p, ta.p)


def test_system_checks():
    """Construction-time shape checks and the unported options; every fused
    solver of the reference is accepted, an unknown one is refused."""
    with pytest.raises(ValueError, match="coords must map|coords function"):
        tp.mk_system([1.0, 1.0], lambda q: q, lambda q: q.sum(),
                     device="cpu", dtype=F64, n=3)
    with pytest.raises(ValueError, match="inertia_fn requires params"):
        tp.System(None, lambda q: q, lambda q: q.sum(), device="cpu", dtype=F64,
                  inertia_fn=lambda p: p)
    for solver in ("dense", "semiseparable", "linv", "mobius"):
        ex = tp.chain(n_links=3, fused_solver=solver, device="cpu", dtype=F64)
        assert ex.system.fused_forms(ex.system).n == 3
    with pytest.raises(ValueError, match="fused_solver must be one of"):
        tp.chain(n_links=3, fused_solver="qr", device="cpu", dtype=F64)
    ex = tp.chain(n_links=3, device="cpu", dtype=F64)
    with pytest.raises(NotImplementedError, match="M11"):
        tp.make_stepper(ex.system, "gauss4")
    pos = tp.underlying_pos(ex.system, torch.zeros(4, 3, dtype=F64))
    assert pos.shape == (4, 6)
