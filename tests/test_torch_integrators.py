"""The port's fixed-step integrators against the JAX package's, on the CPU.

The mirror of ``tests/test_integrators.py`` for ``make_stepper`` and
``evolve_ham_fixed``: every library method (``rk4``, ``leapfrog``,
``midpoint``, ``gauss4``, ``gauss6``, ``yoshida4``, ``tao2``, ``tao4``) runs
the same float64 inputs, drawn with numpy from a seed, through both packages
on the double pendulum (n = 2, the closed-form solves) and on chain-5 (the
K route at n ≥ 3, the batched solve entries), compensated or not, and with
per-member params for ``gauss4`` (its stages on a leading axis): the
trajectories agree to 1e-12 over 20 steps.  The fused methods' parity lives
in ``tests/test_torch_fused_step.py``.

Then the reference's own checks on the port: convergence orders, bounded
drift, ``rk4`` drifting more than ``gauss4``, the registry and its refusals;
``evolve_ensemble`` (shared, swept and ``system_batched=True``) against the
reference's; the ``dtdq_fn`` and ``pallas_step`` system keywords; and
``gauss4`` against the native C++ engine's closed-form chain dynamics.
Each port run is eager PyTorch, ~5 ms of host time per ``ham_eqs`` on a
CPU, so the long-horizon checks run a tenth of the reference's horizons,
with the reference's limits (each docstring gives its horizon).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamilton_tpu as ht
from hamilton_tpu.ensemble import evolve_ensemble as j_evolve_ensemble
from hamilton_tpu.models import chain as j_chain
from hamilton_tpu.models import double_pendulum as j_double_pendulum

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import native
from hamilton_tpu_torch.integrators.fixed import FIXED_METHODS
from hamilton_tpu_torch.ops.fused_step import FUSED_COMPOSITIONS

F64 = torch.float64
TOL = 1e-12
STEPS = 20
LIBRARY_METHODS = ("rk4", "leapfrog", "midpoint", "gauss4", "gauss6", "yoshida4", "tao2",
                   "tao4")
COMPENSATED_METHODS = ("leapfrog", "midpoint", "gauss4", "gauss6")
SYSTEMS = ("double_pendulum", "chain5")


def _examples(name):
    """``(reference example, port example)``."""
    if name == "double_pendulum":
        return j_double_pendulum(), tp.double_pendulum(device="cpu", dtype=F64)
    return j_chain(n_links=5), tp.chain(n_links=5, device="cpu", dtype=F64)


def _inputs(jex, batch=3, seed=0):
    """A batch around the example's initial phase, numpy float64."""
    rng = np.random.default_rng(seed)
    q0, p0 = np.asarray(jex.init_phase.q), np.asarray(jex.init_phase.p)
    n = q0.shape[-1]
    return (q0 + 0.05 * rng.standard_normal((batch, n)),
            p0 + 0.05 * rng.standard_normal((batch, n)))


def _both(jsys, tsys, q, p, dt, n_steps, **kw):
    """The same ``evolve_ham_fixed`` through both packages: numpy outputs."""
    jout = ht.evolve_ham_fixed(jsys, ht.Phase(jnp.asarray(q), jnp.asarray(p)), dt, n_steps,
                               **kw)
    tout = tp.evolve_ham_fixed(tsys, tp.Phase(torch.tensor(q), torch.tensor(p)), dt, n_steps,
                               **kw)
    return (np.asarray(jout.q), np.asarray(jout.p)), (tout.q.numpy(), tout.p.numpy())


def _assert_close(want, got, tol=TOL):
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


# ----------------------------------------------------------------------
# Parity with the reference, method by method
# ----------------------------------------------------------------------


@pytest.mark.parametrize("method", LIBRARY_METHODS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_matches_reference(system, method):
    """Each library method over 20 steps from 3 members, emitted every 5
    steps: the port's trajectory is the reference's to 1e-12."""
    jex, tex = _examples(system)
    q, p = _inputs(jex)
    want, got = _both(jex.system, tex.system, q, p, 0.01, STEPS, method=method,
                      emit_every=5)
    _assert_close(want, got)


@pytest.mark.parametrize("method", COMPENSATED_METHODS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_compensated_matches_reference(system, method):
    """The Kahan-compensated leapfrog and Gauss family, carries and all:
    the reference's trajectory to 1e-12."""
    jex, tex = _examples(system)
    q, p = _inputs(jex, seed=1)
    want, got = _both(jex.system, tex.system, q, p, 0.01, STEPS, method=method,
                      emit_every=STEPS, compensated=True)
    _assert_close(want, got)


@pytest.mark.parametrize("system", SYSTEMS)
def test_gauss4_batched_params_matches_reference(system):
    """A parameter sweep: per-member params, so the stages stay a leading
    axis (the solves see (2, 3, n, n)) and the params pair with the members;
    the reference's trajectory to 1e-12."""
    jex, tex = _examples(system)
    q, p = _inputs(jex, seed=2)
    rng = np.random.default_rng(3)
    if system == "double_pendulum":
        params = {"m1": 1.0 + 0.1 * rng.standard_normal(3),
                  "m2": 1.0 + 0.1 * rng.standard_normal(3)}
    else:
        params = {"masses": 1.0 + 0.1 * rng.standard_normal((3, 5)),
                  "lengths": 1.0 + 0.1 * rng.standard_normal((3, 5)),
                  "gravity": 5.0 + 0.1 * rng.standard_normal(3)}
    jsys = jex.system.replace_params({k: jnp.asarray(v) for k, v in params.items()})
    tsys = tex.system.replace_params(tp.params_from_numpy(params, device="cpu", dtype=F64))
    assert tsys.param_batch_ndim() == 1
    want, got = _both(jsys, tsys, q, p, 0.01, STEPS, emit_every=5)
    _assert_close(want, got)


# ----------------------------------------------------------------------
# The reference's checks (tests/test_integrators.py), on the port
# ----------------------------------------------------------------------

JDP = j_double_pendulum()
DP = tp.double_pendulum(device="cpu", dtype=F64)


def _h(system, q, p):
    return tp.hamiltonian(system, tp.Phase(q, p))


@pytest.mark.parametrize("method,order", [("rk4", 4), ("midpoint", 2), ("gauss4", 4),
                                          ("leapfrog", 2), ("yoshida4", 4), ("tao2", 2)])
def test_fixed_step_convergence_order(method, order):
    """Each method converges at its nominal order on the double pendulum
    (non-separable H): the error at t = 0.4 against a tight dopri5 oracle
    (the reference's adaptive driver at 1e-13) halves by 2^order when the
    step halves, within the reference's margin."""
    t_end = 0.4
    ref = ht.evolve_ham(JDP.system, JDP.init_phase, jnp.array([0.0, t_end]), eps_abs=1e-13,
                        eps_rel=1e-13, method="dopri5")
    ref_q = np.asarray(ref.q[1])
    errs = []
    for n in (30, 60):
        out = tp.evolve_ham_fixed(DP.system, DP.init_phase, t_end / n, n, method=method,
                                  emit_every=n, iters=5, omega=50.0)
        errs.append(np.max(np.abs(out.q[-1].numpy() - ref_q)))
    rate = np.log2(errs[0] / errs[1])
    assert rate > order - 0.55, f"{method}: observed rate {rate:.2f}, errs {errs}"


@pytest.mark.parametrize("method", ["leapfrog", "midpoint", "gauss4", "gauss6", "yoshida4",
                                    "tao4"])
def test_symplectic_bounded_drift_double_pendulum(method):
    """The symplectic members keep |ΔH/H₀| small on the chaotic double
    pendulum, under the reference's limits: dt = 5e-3, iters = 8, ω = 40,
    over 200 steps (t = 1; the reference runs t = 10)."""
    h0 = float(_h(DP.system, DP.init_phase.q, DP.init_phase.p))
    out = tp.evolve_ham_fixed(DP.system, DP.init_phase, 0.005, 200, method=method,
                              emit_every=20, iters=8, omega=40.0)
    drift = float(((_h(DP.system, out.q, out.p) - h0) / h0).abs().max())
    limit = {"leapfrog": 2e-3, "midpoint": 2e-3, "tao4": 2e-3,
             "yoshida4": 5e-5, "gauss4": 5e-6, "gauss6": 5e-8}[method]
    assert drift < limit, f"{method}: drift {drift:.2e}"


def test_gauss4_drift_tiny_at_small_dt():
    """gauss4 at dt = 1e-3 keeps the drift far below 1e-6: under the
    reference's 1e-9 over 1000 steps (the reference runs 1e4)."""
    h0 = float(_h(DP.system, DP.init_phase.q, DP.init_phase.p))
    out = tp.evolve_ham_fixed(DP.system, DP.init_phase, 1e-3, 1000, emit_every=100)
    drift = float(((_h(DP.system, out.q, out.p) - h0) / h0).abs().max())
    assert drift < 1e-9, f"gauss4 drift {drift:.2e}"


def test_rk4_drifts_more_than_gauss4():
    """The non-symplectic member drifts secularly, the symplectic one does
    not: dt = 0.01, iters = 8, over 200 steps (the reference runs 2000)."""
    h0 = float(_h(DP.system, DP.init_phase.q, DP.init_phase.p))

    def drift_of(method):
        out = tp.evolve_ham_fixed(DP.system, DP.init_phase, 0.01, 200, method=method,
                                  emit_every=200, iters=8)
        return abs((float(_h(DP.system, out.q[-1], out.p[-1])) - h0) / h0)

    assert drift_of("gauss4") < drift_of("rk4") + 1e-12


def test_all_methods_construct_and_step():
    """Every method of FIXED_METHODS builds and steps on the pendulum (the
    fused ones on a batch, through their plain version on the CPU)."""
    ex = tp.pendulum(theta0=0.1, omega0=0.0, device="cpu", dtype=F64)
    ph0 = ex.init_phase
    dt = torch.tensor(0.01, dtype=F64)
    for method in FIXED_METHODS:
        if method.endswith("_fused"):
            st = tp.make_stepper(ex.system, method, iters=(2, 1))
            ph = tp.Phase(ph0.q.expand(4, 1).contiguous(), ph0.p.expand(4, 1).contiguous())
        else:
            st = tp.make_stepper(ex.system, method, iters=4, omega=10.0)
            ph = ph0
        out = st.extract(st.step(st.init(ph), dt))
        assert out.q.shape == ph.q.shape, method
        assert bool(torch.isfinite(out.q).all()), method


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown fixed-step method"):
        tp.make_stepper(DP.system, "nope")


def test_split_iteration_counts():
    """(iters_p, iters_q) splits the leapfrog loops; the warm-started split
    counts land within the converged step's accuracy, the Gauss-Seidel mode
    (2, 0) too; a split count is refused for any other method."""
    def run(iters, n=200):
        return tp.evolve_ham_fixed(DP.system, DP.init_phase, 1e-3, n, method="leapfrog",
                                   iters=iters, emit_every=n).q[-1].numpy()

    ref = run((8, 8))
    np.testing.assert_allclose(run((2, 1)), ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(run((2, 0)), ref, rtol=0, atol=1e-8)
    with pytest.raises(ValueError, match="split"):
        tp.make_stepper(DP.system, "gauss4", iters=(2, 1))


def test_argument_refusals():
    """The reference's refusals: compensation outside the leapfrog and
    Gauss families, steps_per_call outside the fused methods, a fused
    method on a system with neither fused forms nor a pallas_step."""
    for method in ("rk4", "yoshida4", "tao2", "tao4"):
        with pytest.raises(ValueError, match="compensated"):
            tp.make_stepper(DP.system, method, compensated=True)
    with pytest.raises(ValueError, match="steps_per_call"):
        tp.make_stepper(DP.system, "gauss4", steps_per_call=2)
    bare = tp.mk_system([1.0, 1.0], lambda q: q, lambda q: 0.5 * torch.sum(q * q),
                        device="cpu", dtype=F64, n=2)
    with pytest.raises(ValueError, match="fused-kernel"):
        tp.make_stepper(bare, "leapfrog_fused")
    with pytest.raises(ValueError, match="order 2 or 4"):
        from hamilton_tpu_torch.integrators.fixed import _tao_stepper
        _tao_stepper(bare, 20.0, 6)


def test_compensated_matches_plain_in_f64():
    """At float64 the compensation changes gauss4 by ~1e-12 only."""
    plain = tp.evolve_ham_fixed(DP.system, DP.init_phase, 1e-2, 100, emit_every=100)
    comp = tp.evolve_ham_fixed(DP.system, DP.init_phase, 1e-2, 100, emit_every=100,
                               compensated=True)
    np.testing.assert_allclose(comp.q[-1].numpy(), plain.q[-1].numpy(), rtol=1e-12)


@pytest.mark.parametrize("method", ["gauss4", "rk4", "tao2", "yoshida4"])
def test_remat_every_method(method):
    """``remat=True`` carries every method's carry (the Tao state, the
    leapfrog's factor and warm starts) through the recomputing backward:
    the gradient equals the one that keeps the intermediates."""
    grads = []
    for remat in (False, True):
        q = DP.init_phase.q.clone().requires_grad_(True)
        out = tp.evolve_ham_fixed(DP.system, tp.Phase(q, DP.init_phase.p), 0.01, 6,
                                  emit_every=6, iters=3, method=method, remat=remat)
        grads.append(torch.autograd.grad(out.q[-1].sum(), q)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-12, atol=0)


def test_dt_stays_a_tensor_on_the_state_device():
    """Tao's rotation and the triple jump's weights take dt as it comes: a
    0-d tensor stays a tensor in its dtype (on the card: no
    value read back to the host)."""
    from hamilton_tpu_torch.integrators.fixed import _TaoState, _tao_flows, _triple_jump

    dt = torch.tensor(0.01, dtype=F64)
    seen = []
    composed = _triple_jump(lambda state, d: seen.append(d) or state, 2)
    composed(None, dt)
    _, _, phi_c = _tao_flows(DP.system, 20.0)
    real_cos = torch.cos
    torch.cos = lambda x: seen.append(x) or real_cos(x)
    try:
        st = phi_c(_TaoState(*[torch.ones(2, dtype=F64)] * 4), dt)
    finally:
        torch.cos = real_cos
    assert len(seen) == 4 and all(isinstance(x, torch.Tensor) and x.dtype == F64
                                  and x.ndim == 0 for x in seen)
    assert isinstance(st, _TaoState) and st.q.dtype == F64


# ----------------------------------------------------------------------
# evolve_ensemble
# ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["shared", "sweep", "system_batched_params"])
def test_evolve_ensemble_matches_reference(case):
    """``evolve_ensemble`` on chain-3 (K route), 3 members, gauss4: a shared
    system and a params sweep, the sweep also declared with
    ``system_batched=True`` (which the reference maps with ``jax.vmap`` and
    the port runs batch-native): the reference's trajectory to 1e-12, axes
    (time, batch, n)."""
    jex, tex = j_chain(n_links=3), tp.chain(n_links=3, device="cpu", dtype=F64)
    q, p = _inputs(jex, seed=4)
    jsys, tsys = jex.system, tex.system
    if case != "shared":
        rng = np.random.default_rng(5)
        params = {"masses": 1.0 + 0.1 * rng.standard_normal((3, 3)),
                  "lengths": np.ones((3, 3)), "gravity": 5.0 + rng.standard_normal(3)}
        jsys = jsys.replace_params({k: jnp.asarray(v) for k, v in params.items()})
        tsys = tsys.replace_params(tp.params_from_numpy(params, device="cpu", dtype=F64))
    kw = dict(method="gauss4", emit_every=5, system_batched=case.startswith("system"))
    jout = j_evolve_ensemble(jsys, ht.Phase(jnp.asarray(q), jnp.asarray(p)), 0.01, STEPS, **kw)
    tout = tp.evolve_ensemble(tsys, tp.Phase(torch.tensor(q), torch.tensor(p)), 0.01, STEPS,
                              **kw)
    assert tuple(tout.q.shape) == (STEPS // 5 + 1, 3, 3)
    _assert_close((np.asarray(jout.q), np.asarray(jout.p)), (tout.q.numpy(), tout.p.numpy()))


def _hand_built(lib, case):
    """``(system, q0, p0)`` of a hand-built system with unit inertia and a
    mass-independent potential, so that the inertia is the only swept
    quantity: the reference's free particle in a quadratic well (n = 2,
    closed-form solves), or a planar three-link chain with unit links in
    Cartesian gravity (n = 3, m = 6: the J route's batched solves)."""
    xp = jnp if lib is ht else torch
    kw = {} if lib is ht else dict(device="cpu", dtype=F64)
    if case == "particle":
        system = lib.mk_system(xp.ones(2, **kw), lambda q: q,
                               lambda q: 0.5 * xp.sum(q ** 2), n=2, **kw)
        return system, [1.0, 0.0], [0.0, 1.0]

    def coords(q):
        x, y = xp.cumsum(xp.sin(q), 0), -xp.cumsum(xp.cos(q), 0)
        return xp.stack([x, y], -1).reshape(6)

    system = lib.mk_system_cart(xp.ones(6, **kw), coords, lambda x: x[1] + x[3] + x[5],
                                n=3, **kw)
    return system, [0.4, 0.2, -0.3], [0.1, -0.2, 0.3]


@pytest.mark.parametrize("case", ["particle", "chain3"])
def test_evolve_ensemble_system_batched_inertia(case):
    """The reference's legacy sweep: a hand-built system whose inertia
    vector carries the batch axis (the reference's tree_map over the
    inertia leaf, the port's ``replace_inertia``), declared with
    ``system_batched=True``; the port pairs the inertia with the members, so
    on chain-3 the gauss4 stages stay a leading axis and its solves see
    (2, 4, 6, 3): the reference's trajectory to 1e-12, and heavier members
    move slower."""
    b = 4
    scales = np.linspace(1.0, 2.0, b)
    j0, q0, p0 = _hand_built(ht, case)
    t0, _, _ = _hand_built(tp, case)
    m = t0.m
    inertias = scales[:, None] * np.ones((1, m))
    jsys = jax.tree_util.tree_map(
        lambda leaf: jnp.asarray(inertias) if leaf.shape == (m,) else leaf, j0)
    tsys = t0.replace_inertia(torch.tensor(inertias))
    assert tsys.member_batch_ndim() == 1
    q, p = np.tile(q0, (b, 1)), np.tile(p0, (b, 1))
    jout = j_evolve_ensemble(jsys, ht.Phase(jnp.asarray(q), jnp.asarray(p)), 0.01, 20,
                             method="gauss4", emit_every=20, system_batched=True)
    tout = tp.evolve_ensemble(tsys, tp.Phase(torch.tensor(q), torch.tensor(p)), 0.01, 20,
                              method="gauss4", emit_every=20, system_batched=True)
    assert tuple(tout.q.shape) == (2, b, len(q0))
    _assert_close((np.asarray(jout.q), np.asarray(jout.p)), (tout.q.numpy(), tout.p.numpy()))
    moved = (tout.q[-1] - tout.q[0]).abs().sum(-1)
    assert float(moved[0]) > float(moved[-1])


def test_replace_inertia_checks():
    """``replace_inertia`` keeps ``m`` as the trailing axis, drops the
    closed forms written for the old masses, and refuses a system that
    derives its inertia from params; a batched inertia must match the
    state's batch, and ``system_batched=True`` needs a batched system."""
    t0, _, _ = _hand_built(tp, "chain3")
    with pytest.raises(ValueError, match="must end in"):
        t0.replace_inertia(torch.ones(4, 5, dtype=F64))
    with pytest.raises(ValueError, match="inertia_fn"):
        DP.system.replace_inertia(torch.ones(4, 4, dtype=F64))
    pend = tp.pendulum(device="cpu", dtype=F64).system
    assert pend.fused_forms is not None
    swept = pend.replace_inertia(torch.ones(3, 2, dtype=F64))
    assert swept.fused_forms is None and swept.pallas_step is None
    assert swept.mass_matrix_fn is None and swept.dtdq_fn is None
    sysb = t0.replace_inertia(torch.ones(4, 6, dtype=F64))
    ph = tp.Phase(torch.zeros(3, 3, dtype=F64), torch.zeros(3, 3, dtype=F64))
    with pytest.raises(ValueError, match="trailing batch axes"):
        tp.hamiltonian(sysb, ph)
    with pytest.raises(ValueError, match="system_batched=True needs"):
        tp.evolve_ensemble(t0, ph, 0.01, 2, system_batched=True)


def test_ensemble_final_drivers_take_omega():
    """``evolve_ensemble_final`` and ``evolve_ensemble_chunked`` pass
    ``omega`` to Tao's method: the reference's final state to 1e-12."""
    from hamilton_tpu.ensemble import evolve_ensemble_final as j_final

    q, p = _inputs(JDP, seed=6)
    kw = dict(method="tao2", omega=35.0, drift_every=10)
    jfin, jdrift = j_final(JDP.system, ht.Phase(jnp.asarray(q), jnp.asarray(p)), 0.01, 20, **kw)
    ph = tp.Phase(torch.tensor(q), torch.tensor(p))
    fin, drift = tp.evolve_ensemble_final(DP.system, ph, 0.01, 20, **kw)
    chk, _ = tp.evolve_ensemble_chunked(DP.system, ph, 0.01, 20, chunk_steps=10, **kw)
    _assert_close((np.asarray(jfin.q), np.asarray(jfin.p)), (fin.q.numpy(), fin.p.numpy()))
    np.testing.assert_allclose(drift.numpy(), np.asarray(jdrift), rtol=0, atol=TOL)
    assert torch.equal(chk.q, fin.q) and torch.equal(chk.p, fin.p)
    other, _ = tp.evolve_ensemble_final(DP.system, ph, 0.01, 20, method="tao2", omega=20.0,
                                        drift_every=10)
    assert not torch.equal(other.q, fin.q)


# ----------------------------------------------------------------------
# The dtdq_fn and pallas_step keywords (tests/test_examples.py:234-270)
# ----------------------------------------------------------------------


def _bead(lib, override, params):
    """A bead on a parabola: coords q ↦ (q, a·q²) with unit masses, so
    K = 1 + 4a²q², T = ½w²(1 + 4a²q²) and ∂T/∂q = 4a²·q·w²."""
    ones = lib.ones(2, dtype=lib.float64)
    if params:
        def coords(q, pr):
            return lib.concatenate([q, pr["a"] * q * q]) if lib is jnp else \
                torch.cat([q, pr["a"] * q * q])

        def potential(q, pr):
            return lib.sum(q * q)

        dtdq = (lambda q, w, pr: 4.0 * pr["a"] ** 2 * q * w * w) if override else None
        kw = dict(params={"a": lib.asarray(1.0, dtype=lib.float64)})
    else:
        def coords(q):
            return lib.concatenate([q, q * q]) if lib is jnp else torch.cat([q, q * q])

        def potential(q):
            return lib.sum(q * q)

        dtdq = (lambda q, w: 4.0 * q * w * w) if override else None
        kw = {}
    if lib is jnp:
        return ht.mk_system(ones, coords, potential, n=1, dtdq_fn=dtdq, **kw)
    return tp.mk_system(ones, coords, potential, device="cpu", dtype=F64, n=1, dtdq_fn=dtdq,
                        **kw)


@pytest.mark.parametrize("params", [False, True], ids=["no_params", "batched_params"])
def test_dtdq_fn_override_matches_ad_sweep(params):
    """A ``dtdq_fn`` slots into the dynamics where the AD sweep sits, with
    the reference's negation, mapped member-wise with or without (batched)
    params: ham_eqs equals the sweep's to 1e-12, and the reference's
    override run through gauss4 equals the port's to 1e-12."""
    from hamilton_tpu import mechanics as jmech

    rng = np.random.default_rng(7)
    q = rng.uniform(-2, 2, (6, 1))
    p = rng.uniform(-1, 1, (6, 1))
    over, plain = _bead(torch, True, params), _bead(torch, False, params)
    jover = _bead(jnp, True, params)
    if params:
        a = 0.5 + rng.uniform(0, 1, 6)
        over = over.replace_params({"a": torch.tensor(a)})
        plain = plain.replace_params({"a": torch.tensor(a)})
        jover = jover.replace_params({"a": jnp.asarray(a)})
    ph = tp.Phase(torch.tensor(q), torch.tensor(p))
    for x, y in zip(tp.ham_eqs(over, ph), tp.ham_eqs(plain, ph)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12, atol=1e-12)
    jph = ht.Phase(jnp.asarray(q), jnp.asarray(p))
    for x, y in zip(tp.ham_eqs(over, ph), jmech.ham_eqs(jover, jph)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=TOL)
    want, got = _both(jover, over, q, p, 0.01, STEPS, emit_every=STEPS)
    _assert_close(want, got)


def test_dtdq_fn_shape_validated():
    with pytest.raises(ValueError, match="dtdq_fn must map"):
        tp.mk_system(torch.ones(2), lambda q: q, lambda q: torch.sum(q), device="cpu",
                     dtype=F64, n=2, dtdq_fn=lambda q, w: torch.zeros(3))


def test_keywords_carried_by_to_and_replace_params():
    fn, factory = (lambda q, w, pr: 0.0 * q), (lambda sys, **kw: None)
    ex = tp.chain(n_links=3, device="cpu", dtype=F64)
    sys_ = tp.mk_system_cart(None, ex.system.coords, lambda xs, pr: torch.sum(xs),
                             device="cpu", dtype=F64, n=3, params=ex.system.params,
                             inertia_fn=ex.system.inertia_fn, dtdq_fn=fn,
                             pallas_step=factory)
    for other in (sys_.to(dtype=torch.float32), sys_.replace_params(ex.system.params)):
        assert other.dtdq_fn is fn and other.pallas_step is factory


def test_pallas_step_factory_is_preferred():
    """A ``pallas_step`` factory builds the fused methods' stepper, called
    with the live system and the method's iters, compensation, steps per
    call and composition; it wins over ``fused_forms``, and a factory that
    wraps ``fused_stepper`` steps exactly as the ``fused_forms`` path."""
    calls = []

    def factory(system, **kw):
        calls.append((system, kw))
        return tp.fused_stepper(system.fused_forms(system), **kw)

    dp = DP.system
    sys_ = tp.System(None, dp.coords, dp.potential, device="cpu", dtype=F64, n=2,
                     params=dp.params, inertia_fn=dp.inertia_fn, fused_forms=dp.fused_forms,
                     pallas_step=factory)
    for method in ("leapfrog_fused", "yoshida4_fused", "suzuki4_fused"):
        st = tp.make_stepper(sys_, method, iters=(2, 1), compensated=True, steps_per_call=5)
        system, kw = calls[-1]
        assert system is sys_
        assert kw == dict(iters=(2, 1), compensated=True, steps_per_call=5,
                          composition=FUSED_COMPOSITIONS[method])
        assert st.substeps == 5
    q, p = _inputs(JDP, batch=4, seed=8)
    ph = tp.Phase(torch.tensor(q), torch.tensor(p))
    via = tp.evolve_ham_fixed(sys_, ph, 1e-3, 10, method="leapfrog_fused", iters=(2, 1),
                              emit_every=10)
    forms = tp.evolve_ham_fixed(dp, ph, 1e-3, 10, method="leapfrog_fused", iters=(2, 1),
                                emit_every=10)
    assert torch.equal(via.q, forms.q) and torch.equal(via.p, forms.p)


# ----------------------------------------------------------------------
# The native C++ engine's closed-form chain
# ----------------------------------------------------------------------

def test_gauss4_matches_native_chain():
    """chain-5 float64, gauss4 at dt = 1e-3 over t ∈ [0, 1] against the
    native engine's hand-derived chain dynamics (RKF45 at 1e-13, through the
    port's own binding): within 10x the gap of the JAX package's own gauss4
    at this configuration, measured here on the same inputs."""
    if not native.available():
        pytest.skip("native library unavailable")
    n = 5
    jex = j_chain(n_links=n, theta0=0.5)
    tex = tp.chain(n_links=n, theta0=0.5, device="cpu", dtype=F64)
    ts = np.linspace(0.0, 1.0, 11)
    nat, _ = native.chain_evolve(np.ones(n), np.asarray(jex.init_phase.flatten()), ts,
                                 eps_abs=1e-13, eps_rel=1e-13)

    def gap(q, p):
        return max(np.abs(np.asarray(q) - nat[:, :n]).max(),
                   np.abs(np.asarray(p) - nat[:, n:]).max())

    ref = ht.evolve_ham_fixed(jex.system, jex.init_phase, 1e-3, 1000, emit_every=100)
    out = tp.evolve_ham_fixed(tex.system, tex.init_phase, 1e-3, 1000, emit_every=100)
    jax_gap, port_gap = gap(ref.q, ref.p), gap(out.q.numpy(), out.p.numpy())
    assert 0 < jax_gap < 1e-10, jax_gap
    assert port_gap <= 10 * jax_gap, (port_gap, jax_gap)
