"""Parameter sweeps and order-4 compositions of the port's fused step
(``hamilton_tpu_torch/ops/fused_step.py``) against the JAX package, on the
CPU.

A sweep gives every ensemble member its own masses and gravity: the params
carry a leading batch axis, the library path maps them member by member, and
the fused step reads a per-member coefficient table.  The compositions run
the Yoshida triple jump or Suzuki's five stages inside each fused step.
Inputs are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hamilton_tpu import models as jmodels
from hamilton_tpu.integrators.fixed import make_stepper as j_make_stepper
from hamilton_tpu.mechanics import hamiltonian as j_hamiltonian
from hamilton_tpu.mechanics import q_factor as j_q_factor
from hamilton_tpu.ops import pallas_step as j_step
from hamilton_tpu.state import Phase as JPhase

import hamilton_tpu_torch as tp
from hamilton_tpu_torch.convert import params_from_numpy, phase_from_numpy
from hamilton_tpu_torch.ops import fused_step as t_step

F64 = torch.float64
N = 4


def _sweep(batch, seed=5):
    """Per-member masses, lengths broadcast to (B, n), per-member gravity,
    and a jittered phase, as numpy arrays."""
    rng = np.random.default_rng(seed)
    params = {
        "masses": 0.5 + rng.random((batch, N)),
        "lengths": np.ones((batch, N)),
        "gravity": 4.0 + rng.random(batch),
    }
    q = 0.5 + 0.01 * rng.standard_normal((batch, N))
    p = 0.01 * rng.standard_normal((batch, N))
    return params, q, p


def _systems(params, solver="semiseparable"):
    jsys = jmodels.chain(n_links=N, fused_solver=solver).system
    jsys = jsys.replace_params({k: jnp.asarray(v) for k, v in params.items()})
    tsys = tp.chain(n_links=N, fused_solver=solver, device="cpu", dtype=F64).system
    tsys = tsys.replace_params(params_from_numpy(params, device="cpu", dtype=F64))
    return jsys, tsys


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


def test_composition_constants_equal_the_reference():
    assert t_step.YOSHIDA4_COMPOSITION == j_step.YOSHIDA4_COMPOSITION
    assert t_step.SUZUKI4_COMPOSITION == j_step.SUZUKI4_COMPOSITION
    assert t_step.SUZUKI4_COMPOSITION[2] < 0  # the middle weight 1 − 4·S5


def test_per_member_mechanics_match_reference():
    """hamiltonian and q_factor with (B, ·) params, each member under its
    own masses and gravity: the same closed forms, so float64 rounding
    (1e-13 on H ~ 10 and on the factor and force)."""
    params, q, p = _sweep(16)
    jsys, tsys = _systems(params)
    tph = phase_from_numpy(q, p, device="cpu", dtype=F64)
    _close(j_hamiltonian(jsys, JPhase(jnp.asarray(q), jnp.asarray(p))),
           tp.hamiltonian(tsys, tph).numpy(), 1e-13)
    jf, tf = j_q_factor(jsys, jnp.asarray(q)), tp.q_factor(tsys, tph.q)
    _close(jf.chol, tf.chol.numpy(), 1e-13)
    _close(jf.grad_u, tf.grad_u.numpy(), 1e-13)
    assert tsys.param_batch_ndim() == 1
    # a trajectory axis in front of the members holds the params fixed
    qq = torch.stack([tph.q, tph.q + 0.01])
    assert tp.pe(tsys, qq).shape == (2, 16)
    torch.testing.assert_close(tp.pe(tsys, qq)[0], tp.pe(tsys, tph.q), rtol=0, atol=0)


@pytest.mark.parametrize("solver", ["semiseparable", "dense"])
def test_per_member_fused_matches_reference_library(solver):
    """Per-member tables in the plain version of the fused step, float64
    (3,2), two steps, against the reference's library leapfrog of the same
    swept system: the same fixed points through different linear algebra,
    so 1e-12 (as the reference's own fused-vs-library test)."""
    params, q, p = _sweep(16)
    jsys, tsys = _systems(params, solver)
    dt = 1e-3
    lib = j_make_stepper(jsys, "leapfrog", iters=(3, 2))
    cl = lib.init(JPhase(jnp.asarray(q), jnp.asarray(p)))
    fus = tp.make_stepper(tsys, "leapfrog_fused", iters=(3, 2))
    cf = fus.init(phase_from_numpy(q, p, device="cpu", dtype=F64))
    state, table = cf
    assert table.shape == (sum(tsys.fused_forms(tsys).coef_lens), 16)
    for _ in range(2):
        cl = lib.step(cl, jnp.float64(dt))
        cf = fus.step(cf, torch.tensor(dt, dtype=F64))
    assert cf[1] is table  # the table rides with the state unchanged
    a, b = lib.extract(cl), fus.extract(cf)
    _close(a.q, b.q.numpy(), 1e-12)
    _close(a.p, b.p.numpy(), 1e-12)


def test_per_member_fused_matches_reference_kernel():
    """The plain version with per-member tables against the reference's
    fused kernel in its runtime-table mode (interpret mode), B = 1024, one
    call of one step, float64 (2,0) with Kahan: the same operations in the
    same order, so 1e-13 on every state vector (dt·vdot_est for the
    velocity derivative, the force relative to its largest magnitude)."""
    params, q, p = _sweep(1024, seed=6)
    jsys, tsys = _systems(params)
    kw = dict(iters=(2, 0), compensated=True)
    jst = j_make_stepper(jsys, "leapfrog_fused", **kw)
    tst = tp.make_stepper(tsys, "leapfrog_fused", **kw)
    dt = 5e-4
    with pltpu.force_tpu_interpret_mode():
        jc = jst.step(jst.init(JPhase(jnp.asarray(q), jnp.asarray(p))), jnp.float64(dt))
        jc = [np.moveaxis(np.asarray(t), 1, 3).reshape(1024, N) for t in jc[:6]]
    tc, _ = tst.step(tst.init(phase_from_numpy(q, p, device="cpu", dtype=F64)),
                     torch.tensor(dt, dtype=F64))
    for v, ref in enumerate(jc):
        got = tc[v].T.numpy()
        if v == 5:  # vdot_est
            _close(dt * ref, dt * got, 1e-13)
        elif v == 4:  # a_est
            _close(ref, got, 1e-13 * max(1.0, float(np.abs(ref).max())))
        else:
            _close(ref, got, 1e-13)


@pytest.mark.parametrize("method", ["yoshida4_fused", "suzuki4_fused"])
@pytest.mark.parametrize("swept", [False, True], ids=["shared", "per_member"])
def test_composition_matches_reference_library_substeps(method, swept):
    """One fused step of a composition ≡ the reference's library leapfrog
    stepped at w·dt for each weight w (as tests/test_pallas_step.py checks
    the reference's own kernel), float64 (3,2): 1e-12."""
    params, q, p = _sweep(16, seed=8)
    if swept:
        jsys, tsys = _systems(params)
    else:
        jsys = jmodels.chain(n_links=N, fused_solver="semiseparable").system
        tsys = tp.chain(n_links=N, fused_solver="semiseparable", device="cpu",
                        dtype=F64).system
    dt = 2e-3
    weights = {"yoshida4_fused": j_step.YOSHIDA4_COMPOSITION,
               "suzuki4_fused": j_step.SUZUKI4_COMPOSITION}[method]
    lib = j_make_stepper(jsys, "leapfrog", iters=(3, 2))
    cl = lib.init(JPhase(jnp.asarray(q), jnp.asarray(p)))
    for w in weights:
        cl = lib.step(cl, w * jnp.float64(dt))
    fus = tp.make_stepper(tsys, method, iters=(3, 2))
    assert fus.order == 4 and fus.symplectic
    b = fus.extract(fus.step(fus.init(phase_from_numpy(q, p, device="cpu", dtype=F64)),
                             torch.tensor(dt, dtype=F64)))
    a = lib.extract(cl)
    _close(a.q, b.q.numpy(), 1e-12)
    _close(a.p, b.p.numpy(), 1e-12)


def test_size1_param_batch_raises():
    """A size-1 params batch against a larger state batch is refused, by the
    fused stepper's init and by the library path, as the reference refuses
    it (its library path maps members pairwise and never broadcasts)."""
    _, q, p = _sweep(8)
    ex = tp.chain(n_links=N, fused_solver="semiseparable", device="cpu", dtype=F64)
    sysb = ex.system.replace_params(params_from_numpy({
        "masses": np.ones((1, N)), "lengths": np.ones((1, N)),
        "gravity": np.full((1,), 5.0),
    }, device="cpu", dtype=F64))
    ph = phase_from_numpy(q, p, device="cpu", dtype=F64)
    fus = tp.make_stepper(sysb, "leapfrog_fused", iters=(2, 1))
    with pytest.raises(ValueError, match="equal to the state batch"):
        fus.init(ph)
    with pytest.raises(ValueError, match="trailing batch axes"):
        tp.hamiltonian(sysb, ph)


def test_param_batch_checks():
    """replace_params keeps each leaf's shape as its trailing axes, with
    the same number of batch axes on every leaf; a member-level call on a
    swept system needs its member's params."""
    ex = tp.chain(n_links=N, device="cpu", dtype=F64)
    assert ex.system.param_batch_ndim() == 0
    with pytest.raises(ValueError, match="must end in"):
        ex.system.replace_params({"masses": torch.ones(3, N + 1, dtype=F64),
                                  "lengths": torch.ones(3, N, dtype=F64),
                                  "gravity": torch.ones(3, dtype=F64)})
    with pytest.raises(ValueError, match="inconsistent params batching"):
        ex.system.replace_params({"masses": torch.ones(3, N, dtype=F64),
                                  "lengths": torch.ones(N, dtype=F64),
                                  "gravity": torch.ones(3, dtype=F64)})
    params, _, _ = _sweep(3)
    _, sysb = _systems(params)
    with pytest.raises(ValueError, match="explicit member"):
        sysb.jacobian(torch.zeros(N, dtype=F64))
    assert sysb.inertia.shape == (3, 2 * N)
    assert sysb.to(dtype=torch.float32).params["masses"].shape == (3, N)


def test_chunked_sweep_resumes_exactly():
    """evolve_ensemble_chunked with per-member params: the carry holds the
    per-member table beside the state, and restarting from a saved carry
    and drift continues bitwise like the uninterrupted run."""
    params, q, p = _sweep(16, seed=9)
    _, tsys = _systems(params)
    ph0 = phase_from_numpy(q, p, device="cpu", dtype=F64)
    run = dict(method="leapfrog_fused", iters=(2, 0), compensated=True,
               drift_every=5, steps_per_call=5, chunk_steps=10, drift_dtype=F64)
    saved = {}

    def keep(ci, carry, drift):
        state, table = carry
        saved[ci] = ((state.clone(), table.clone()), drift.clone())

    full, dfull = tp.evolve_ensemble_chunked(tsys, ph0, 1e-3, 30, carry_callback=keep,
                                             **run)
    assert float(dfull.max()) > 0.0
    rest, drest = tp.evolve_ensemble_chunked(tsys, ph0, 1e-3, 20, initial_carry=saved[0][0],
                                             initial_drift=saved[0][1], **run)
    assert torch.equal(full.q, rest.q) and torch.equal(full.p, rest.p)
    assert torch.equal(dfull, drest)


def test_one_coefficient_table_argument():
    """``coef=`` is the kernel's one table: the ``(L, B)`` per-member table,
    required with batched params, or the optional flat ``(L,)`` shared one;
    the plain version checks it as the kernel does."""
    params, q, p = _sweep(6)
    _, tsys = _systems(params)
    forms = tsys.fused_forms(tsys)
    state, table = t_step.fused_stepper(forms, iters=(2, 0)).init(
        phase_from_numpy(q, p, device="cpu", dtype=F64))
    kw = dict(iters=(2, 0), compensated=False)
    with pytest.raises(ValueError, match=r"need their \(L, B\)"):
        t_step.fused_step_reference(forms, state, 1e-3, **kw)
    with pytest.raises(ValueError, match="per-member coefficient table"):
        t_step.fused_step_reference(forms, state, 1e-3, coef=table[:, :5], **kw)
    t_step.fused_step_reference(forms, state, 1e-3, coef=table, **kw)

    shared_sys = tp.chain(n_links=N, fused_solver="semiseparable", device="cpu",
                          dtype=F64).system
    shared = shared_sys.fused_forms(shared_sys)
    flat = t_step.coef_table(shared, "cpu", F64)
    assert flat.shape == (sum(shared.coef_lens),)
    want = t_step.fused_step_reference(shared, state, 1e-3, **kw)
    got = t_step.fused_step_reference(shared, state, 1e-3, coef=flat, **kw)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="shared coefficient table"):
        t_step.fused_step_reference(shared, state, 1e-3, coef=table, **kw)


def test_composition_checks():
    """The kernel takes one to five weights; the check needs no card."""
    on5 = t_step.serial_chain_forms_on([1.0] * 5, [1.0] * 5, 5.0)
    got = t_step.check_kernel_args("cuda", torch.float32, on5, (6, 5, 10),
                                   list(t_step.SUZUKI4_COMPOSITION))
    assert got == t_step.SUZUKI4_COMPOSITION
    with pytest.raises(ValueError, match="1 to 5 weights"):
        t_step.check_kernel_args("cuda", torch.float32, on5, (6, 5, 10), (0.2,) * 6)
    with pytest.raises(ValueError, match="1 to 5 weights"):
        t_step.fused_stepper(on5, composition=())
