"""The port's adaptive GSL-RKF45 drivers (``hamilton_tpu_torch/integrators/
adaptive.py`` and ``evolve.py``) against the JAX package's, in float64 on the
CPU.

The same initial conditions, made with numpy from a seed, go through both
packages; the physical parameters are carried across with
``params_from_numpy``.  Both sides evaluate the same right-hand side with
linear algebra that rounds differently (the reference's unrolled or masked
Cholesky and JAX's sin/cos against the port's batched plain version and
PyTorch's), so each RHS agrees to ~1e-15 relative; the controllers then see
the same error norms, take the same steps (the counts must match exactly),
and the trajectories agree to ``ATOL = 1e-11`` absolute over t ≤ 1 (the
readings are ≲ 1e-13; the state reaches |p| ~ 10 on these models).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamilton_tpu import models as jmodels
from hamilton_tpu.integrators import adaptive as j_adaptive
from hamilton_tpu.integrators import evolve as j_evolve
from hamilton_tpu.integrators import tableaus as j_tableaus
from hamilton_tpu.state import Phase as JPhase

import hamilton_tpu_torch as tp
from hamilton_tpu_torch.convert import params_from_numpy, phase_from_numpy
from hamilton_tpu_torch.integrators import adaptive as t_adaptive
from hamilton_tpu_torch.integrators import tableaus as t_tableaus

F64 = torch.float64
ATOL = 1e-11


def test_tableaus_equal_the_reference():
    """The port's copy of the framework-free tableaus is the reference's,
    coefficient for coefficient."""
    for name in j_tableaus.__all__:
        want, got = getattr(j_tableaus, name), getattr(t_tableaus, name)
        if name == "Tableau":
            assert [f.name for f in dataclasses.fields(want)] == \
                [f.name for f in dataclasses.fields(got)]
            continue
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert set(t_adaptive.ADAPTIVE_METHODS) == set(j_adaptive.ADAPTIVE_METHODS)
    assert t_adaptive.GSL_EPS_DEFAULT == j_adaptive.GSL_EPS_DEFAULT


def _j_oscillators(y, omega):
    """Harmonic oscillators ``y = (x, v)`` of frequencies ``omega``."""
    return jnp.stack([y[..., 1], -(omega**2) * y[..., 0]], axis=-1)


def _t_oscillators(y, omega):
    return torch.stack([y[..., 1], -(omega**2) * y[..., 0]], dim=-1)


@pytest.mark.parametrize("per_member", [False, True], ids=["shared", "per_member"])
def test_gsl_evolve_to_matches_reference(per_member):
    """The controller itself on 6 oscillators of different frequency, over
    two intervals with the suggested step carried between them: every
    per-interval attempt and rejection count equals the reference's."""
    rng = np.random.default_rng(0)
    y0 = rng.standard_normal((6, 2))
    omega = np.linspace(1.0, 9.0, 6)
    j_rhs, t_rhs = _j_oscillators, _t_oscillators
    kw = dict(eps_abs=1e-9, eps_rel=1e-9, return_stats=True)

    if per_member:
        def j_run(y, om, t0, t1, h):
            return j_adaptive.gsl_evolve_to(lambda v: j_rhs(v, om), y, t0, t1, h, **kw)

        j_fn = jax.vmap(j_run, in_axes=(0, 0, None, None, 0))
        jy, jh = jnp.asarray(y0), jnp.full((6,), 0.01)
    else:
        om_j = jnp.asarray(omega)
        j_fn = lambda y, _om, t0, t1, h: j_adaptive.gsl_evolve_to(  # noqa: E731
            lambda v: j_rhs(v, om_j), y, t0, t1, h, **kw)
        jy, jh = jnp.asarray(y0), jnp.asarray(0.01)
    om_t = torch.tensor(omega)
    ty, th = torch.tensor(y0), torch.tensor(0.01, dtype=F64)
    for t0, t1 in ((0.0, 0.7), (0.7, 1.5)):
        jy, jh, jst = j_fn(jy, jnp.asarray(omega), t0, t1, jh)
        ty, th, tst = t_adaptive.gsl_evolve_to(lambda v: t_rhs(v, om_t), ty, t0, t1, th,
                                               per_member=per_member, **kw)
        np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=0, atol=ATOL)
        # the next step grows from rmax^(-1/5), and rmax is a ratio of yerr,
        # a combination of O(1) stage values that cancels to ~1e-10 (less
        # after a short final step): rounding the stages differently moves it
        # by up to ~1e-4 relative, and h by a fifth of that
        np.testing.assert_allclose(np.asarray(jh), th.numpy(), rtol=1e-4)
        for key in ("n_steps", "n_failed", "saturated"):
            np.testing.assert_array_equal(np.asarray(jst[key]), tst[key].numpy(), key)


# ----------------------------------------------------------------------
# evolve_ham on the models
# ----------------------------------------------------------------------


def _carry_params(jsys, tsys):
    if jsys.params is None:
        return tsys
    return tsys.replace_params(params_from_numpy(
        {k: np.asarray(v) for k, v in jsys.params.items()}, device="cpu", dtype=F64))


def _jittered(jex, batch, seed):
    """The reference example's initial phase with 0.01-scale Gaussian jitter
    on q (p from the reference's ``to_phase`` of the jittered config)."""
    from hamilton_tpu.mechanics import to_phase as j_to_phase
    from hamilton_tpu.state import Config as JConfig

    rng = np.random.default_rng(seed)
    q0, v0 = np.asarray(jex.init_config.q), np.asarray(jex.init_config.v)
    q = q0 + 0.01 * rng.standard_normal((batch,) + q0.shape)
    v = np.broadcast_to(v0, q.shape)
    ph = j_to_phase(jex.system, JConfig(jnp.asarray(q), jnp.asarray(v)))
    return np.asarray(ph.q), np.asarray(ph.p)


CASES = {
    # the reference README's flow: one double pendulum, out to t = 1 in 0.1s
    "double_pendulum": (lambda: jmodels.double_pendulum(),
                        lambda: tp.double_pendulum(device="cpu", dtype=F64),
                        None, np.arange(0.0, 1.05, 0.1), "shared"),
    "chain5-shared": (lambda: jmodels.chain(n_links=5), lambda: tp.chain(n_links=5, device="cpu",
                                                                         dtype=F64),
                      8, np.array([0.0, 0.5, 1.0]), "shared"),
    "chain5-per_member": (lambda: jmodels.chain(n_links=5),
                          lambda: tp.chain(n_links=5, device="cpu", dtype=F64),
                          8, np.array([0.0, 0.5, 1.0]), "per_member"),
    "spring": (lambda: jmodels.spring(), lambda: tp.spring(device="cpu", dtype=F64),
               4, np.linspace(0.0, 1.0, 11), "shared"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evolve_ham_matches_reference(case):
    j_make, t_make, batch, ts, mode = CASES[case]
    jex = j_make()
    tsys = _carry_params(jex.system, t_make().system)
    if batch is None:
        q, p = np.asarray(jex.init_phase.q), np.asarray(jex.init_phase.p)
    else:
        q, p = _jittered(jex, batch, seed=0)
    jout, jst = j_evolve.evolve_ham(jex.system, JPhase(jnp.asarray(q), jnp.asarray(p)),
                                    jnp.asarray(ts), batch_mode=mode, return_stats=True)
    tout, tst = tp.evolve_ham(tsys, phase_from_numpy(q, p, device="cpu", dtype=F64), ts,
                              batch_mode=mode, return_stats=True)
    assert tuple(tout.q.shape) == (len(ts),) + q.shape
    np.testing.assert_allclose(np.asarray(jout.q), tout.q.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.asarray(jout.p), tout.p.numpy(), rtol=0, atol=ATOL)
    assert {k: int(v) for k, v in tst.items()} == {k: int(v) for k, v in jst.items()}


def test_list_step_and_configuration_wrappers():
    """evolve_ham_list (empty, singleton, list), step_ham, iterate_ham and the
    configuration-space wrappers, on the double pendulum: each is the
    evolve_ham run it is defined by, and step_ham_c is the reference's."""
    ex = tp.double_pendulum(device="cpu", dtype=F64)
    sys_, ph0, c0 = ex.system, ex.init_phase, ex.init_config
    ts = [0.0, 0.1, 0.2]
    traj = tp.evolve_ham(sys_, ph0, ts)

    assert tp.evolve_ham_list(sys_, ph0, []) == []
    listed = tp.evolve_ham_list(sys_, ph0, ts)
    assert len(listed) == 3
    for i, ph in enumerate(listed):
        assert torch.equal(ph.q, traj.q[i]) and torch.equal(ph.p, traj.p[i])
    (single,), stats = tp.evolve_ham_list(sys_, ph0, [0.1], return_stats=True)
    stepped = tp.step_ham(sys_, ph0, 0.1)
    assert torch.equal(single.q, stepped.q) and torch.equal(single.p, stepped.p)
    assert int(stats["max_interval_steps"]) > 0

    stream = tp.iterate_ham(sys_, ph0, 0.1)
    first, second, third = next(stream), next(stream), next(stream)
    assert first is ph0 and torch.equal(second.q, stepped.q)
    again = tp.step_ham(sys_, stepped, 0.1)
    assert torch.equal(third.q, again.q) and torch.equal(third.p, again.p)

    ctraj = tp.evolve_ham_c(sys_, c0, ts)
    want = tp.from_phase(sys_, traj)
    assert torch.equal(ctraj.q, want.q) and torch.equal(ctraj.v, want.v)
    clist = tp.evolve_ham_c_list(sys_, c0, [0.1])
    cstep = tp.step_ham_c(sys_, c0, 0.1)
    assert len(clist) == 1 and torch.equal(clist[0].v, cstep.v)

    jex = jmodels.double_pendulum()
    jc = j_evolve.step_ham_c(jex.system, jex.init_config, 0.1)
    np.testing.assert_allclose(np.asarray(jc.q), cstep.q.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.asarray(jc.v), cstep.v.numpy(), rtol=0, atol=ATOL)


def test_argument_checks():
    ex = tp.double_pendulum(device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="at least 2 output times"):
        tp.evolve_ham(ex.system, ex.init_phase, [0.5])
    with pytest.raises(ValueError, match="batch_mode"):
        tp.evolve_ham(ex.system, ex.init_phase, [0.0, 0.1], batch_mode="lockstep")
    sp = tp.spring(device="cpu", dtype=F64)
    assert tp.make_stepper(sp.system, "leapfrog_fused").order == 2
    rk4 = tp.make_stepper(sp.system, "rk4")
    assert (rk4.order, rk4.symplectic) == (4, False)
    out = rk4.extract(rk4.step(rk4.init(sp.init_phase), torch.tensor(0.01, dtype=F64)))
    assert out.q.shape == sp.init_phase.q.shape and bool(torch.isfinite(out.q).all())
    with pytest.raises(ValueError, match="unknown fixed-step method"):
        tp.make_stepper(sp.system, "rk5")


def test_host_reads_count_attempts():
    """One value read back per attempt, plus one per interval to leave it."""
    ex = tp.chain(n_links=3, device="cpu", dtype=F64)
    ph = tp.Phase(ex.init_phase.q.expand(2, 3), ex.init_phase.p.expand(2, 3))
    t_adaptive.gsl_evolve_to.host_reads = 0
    _, st = tp.evolve_ham(ex.system, ph, [0.0, 0.1], return_stats=True)
    assert t_adaptive.gsl_evolve_to.host_reads == int(st["max_interval_steps"]) + 1
