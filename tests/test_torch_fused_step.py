"""The port's fused whole-step leapfrog (``hamilton_tpu_torch/ops/fused_step.py``)
against the JAX package, on the CPU.

On a CPU tensor the port runs the plain PyTorch version of its CUDA kernel,
an eager mirror of the reference kernel's arithmetic in the same operation
order.  The reference's fused stepper runs its Pallas kernel in interpret
mode, as ``tests/test_pallas_step.py`` does.  Inputs are made with numpy
from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hamilton_tpu import models as jmodels
from hamilton_tpu.integrators.fixed import make_stepper as j_make_stepper
from hamilton_tpu.ops import pallas_solve as j_solve
from hamilton_tpu.ops import pallas_step as j_step
from hamilton_tpu.state import Phase as JPhase

import hamilton_tpu_torch as tp
from hamilton_tpu_torch.convert import params_from_numpy, phase_from_numpy
from hamilton_tpu_torch.ops import fused_step as t_step

F64 = torch.float64
TILE = 1024  # the reference's fused stepper takes batches of 1024·k


def _to_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol):
    np.testing.assert_allclose(_to_np(a), _to_np(b), rtol=0, atol=atol)


# ----------------------------------------------------------------------
# The closed forms, entry by entry (n = 20, float64)
# ----------------------------------------------------------------------

FAMILIES = {
    "dense": (j_step.serial_chain_forms, t_step.serial_chain_forms),
    "semiseparable": (j_step.serial_chain_forms_on, t_step.serial_chain_forms_on),
}


@pytest.fixture(params=sorted(FAMILIES))
def families(request):
    """The reference's and the port's FamilyFns of one family on the same
    random chain, plus the same random per-member columns for both."""
    n, b = 20, 64
    rng = np.random.default_rng(0)
    m, l = list(0.3 + rng.random(n)), list(0.4 + rng.random(n))
    j_forms, t_forms = (f(m, l, 5.0) for f in FAMILIES[request.param])
    jfam = j_forms.make(j_forms.const_accessors(), j_step.FM_JNP)
    tfam = t_forms.make(t_forms.const_accessors(), t_step.FM_TORCH)
    cols = {k: rng.uniform(-3, 3, (n, b)) if k == "q" else rng.standard_normal((n, b))
            for k in ("q", "w", "b")}
    jcols = {k: [jnp.asarray(r) for r in v] for k, v in cols.items()}
    tcols = {k: [torch.as_tensor(r) for r in v] for k, v in cols.items()}
    return n, jfam, tfam, jcols, tcols


def _factor_solve(fam, n, module):
    """A family's (factor, solve) pair: its own structure-exploiting one, or
    the dense in-register Cholesky of the module it belongs to."""
    if fam.factor_solve is not None:
        return fam.factor_solve
    if module is t_step:
        return t_step._factor_solve_fns(fam, n)

    def factor(aux_v, q):
        low, inv_d = j_solve._chol_entries(fam.k_at(aux_v, q), n)
        return tuple(low[(i, j)] for i in range(n) for j in range(i + 1)) + tuple(inv_d)

    def solve(ent, b):
        low, k = {}, 0
        for i in range(n):
            for j in range(i + 1):
                low[(i, j)] = ent[k]
                k += 1
        return j_solve._solve_entries(low, list(ent[k:]), lambda i: b[i], n)

    return factor, solve


def test_family_aux_and_shift(families):
    n, jfam, tfam, jc, tc = families
    ja, ta = jfam.aux(jc["q"]), tfam.aux(tc["q"])
    assert len(ja) == len(ta) == 2 * n
    for x, y in zip(ja, ta):
        _close(x, y, 1e-15)
    dq_j = [1e-3 * w for w in jc["w"]]
    dq_t = [1e-3 * w for w in tc["w"]]
    for x, y in zip(jfam.aux_shift(ja, dq_j), tfam.aux_shift(ta, dq_t)):
        _close(x, y, 1e-15)


def test_family_mass_matrix_entries(families):
    n, jfam, tfam, jc, tc = families
    jk = jfam.k_at(jfam.aux(jc["q"]), jc["q"])
    tk = tfam.k_at(tfam.aux(tc["q"]), tc["q"])
    for i in range(n):
        for j in range(i + 1):
            _close(jk(i, j), tk(i, j), 1e-14)


def test_family_factor_and_solve(families):
    n, jfam, tfam, jc, tc = families
    jf, js = _factor_solve(jfam, n, j_step)
    tf, ts = _factor_solve(tfam, n, t_step)
    jent = jf(jfam.aux(jc["q"]), jc["q"])
    tent = tf(tfam.aux(tc["q"]), tc["q"])
    assert len(jent) == len(tent)
    for x, y in zip(jent, tent):
        scale = max(1.0, float(np.abs(_to_np(x)).max()))
        _close(x, y, 1e-12 * scale)
    for x, y in zip(js(jent, jc["b"]), ts(tent, tc["b"])):
        _close(x, y, 1e-11)


def test_family_dhdq(families):
    n, jfam, tfam, jc, tc = families
    jd = jfam.dhdq(jfam.aux(jc["q"]), jc["q"], jc["w"])
    td = tfam.dhdq(tfam.aux(tc["q"]), tc["q"], tc["w"])
    scale = max(float(np.abs(_to_np(x)).max()) for x in jd)
    for x, y in zip(jd, td):
        _close(x, y, 1e-12 * scale)


def test_family_potential(families):
    n, jfam, tfam, jc, tc = families
    _close(jfam.potential(jfam.aux(jc["q"]), jc["q"]),
           tfam.potential(tfam.aux(tc["q"]), tc["q"]), 1e-13)


# ----------------------------------------------------------------------
# The plain version against the reference's fused kernel (interpret mode)
# ----------------------------------------------------------------------

# name → (JAX example, port example factory, iters, compensated, dt)
FUSED_CASES = {
    "chain5-semiseparable-2-0-kahan": (
        lambda: jmodels.chain(n_links=5, fused_solver="semiseparable"),
        lambda dtype: tp.chain(n_links=5, fused_solver="semiseparable",
                               device="cpu", dtype=dtype),
        (2, 0), True, 5e-4,
    ),
    "double_pendulum-dense-2-1": (
        lambda: jmodels.double_pendulum(),
        lambda dtype: tp.double_pendulum(device="cpu", dtype=dtype),
        (2, 1), False, 1e-3,
    ),
}

# Tolerances per carry vector of one spc=5 call.  float64: the same
# operations in the same order, differing only by XLA's rounding where it
# fuses (measured ≤ 3e-17 on q, p and ≤ 2e-15 on the force a_est).
# vdot_est = (v₁ − v₀)/dt is compared as dt·vdot_est, the velocity
# difference the kernel actually computes.  float32 (the aux_shift path):
# q, p and the Kahan residuals within 4 ulps of |q| ≈ 0.5 (2.4e-7; measured
# ≤ 1 ulp); the force within 1e-6 relative (~8 ulps); dt·vdot_est within
# 1e-6 — a K⁻¹ solve is good to ~cond(K)·eps, measured 3.3e-7.
FUSED_TOL = {
    "float64": {"state": 1e-13, "a_est": 1e-13, "dt_vdot": 1e-13},
    "float32": {"state": 2.4e-7, "a_est": 1e-6, "dt_vdot": 1e-6},
}


def _tiles_to_members(t):
    """The reference's (G, n, 8, 128) carry tile → (B, n)."""
    t = np.asarray(t)
    return np.moveaxis(t, 1, 3).reshape(t.shape[0] * TILE, t.shape[1])


def _fused_inputs(jex, dtype_name, seed=0):
    n = jex.n
    rng = np.random.default_rng(seed)
    q = np.asarray(jex.init_config.q) + 0.01 * rng.standard_normal((TILE, n))
    p = 0.05 * rng.standard_normal((TILE, n))
    return q.astype(dtype_name), p.astype(dtype_name)


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_plain_version_matches_reference_kernel(case, dtype_name):
    make_j, make_t, iters, comp, dt = FUSED_CASES[case]
    jex = make_j()
    tdtype = getattr(torch, dtype_name)
    tsys = make_t(tdtype).system
    tsys = tsys.replace_params(params_from_numpy(
        {k: np.asarray(v) for k, v in jex.system.params.items()},
        device="cpu", dtype=tdtype,
    ))
    jsys = jax.tree_util.tree_map(lambda a: a.astype(dtype_name), jex.system)
    q, p = _fused_inputs(jex, dtype_name)
    jst = j_make_stepper(jsys, "leapfrog_fused", iters=iters, compensated=comp,
                         steps_per_call=5)
    tst = tp.make_stepper(tsys, "leapfrog_fused", iters=iters, compensated=comp,
                          steps_per_call=5)
    with pltpu.force_tpu_interpret_mode():
        jc = jst.step(jst.init(JPhase(jnp.asarray(q), jnp.asarray(p))),
                      jnp.asarray(dt, dtype_name))
        jc = [_tiles_to_members(t) for t in jc]
    tc = tst.step(tst.init(phase_from_numpy(q, p, device="cpu", dtype=tdtype)),
                  torch.tensor(dt, dtype=tdtype))
    assert tc.shape == (len(jc), jex.n, TILE)
    tol = FUSED_TOL[dtype_name]
    for v, ref in enumerate(jc):
        got = tc[v].T.numpy()
        if v == len(jc) - 1:  # vdot_est
            _close(dt * ref, dt * got, tol["dt_vdot"])
        elif v == len(jc) - 2:  # a_est
            _close(ref, got, tol["a_est"] * max(1.0, float(np.abs(ref).max())))
        else:  # q, p and the Kahan residuals
            _close(ref, got, tol["state"])


# ----------------------------------------------------------------------
# The plain version against the port's own library path
# ----------------------------------------------------------------------

PORT_CASES = {
    "chain5-semiseparable": lambda: tp.chain(n_links=5, fused_solver="semiseparable",
                                             device="cpu", dtype=F64),
    "chain4-dense": lambda: tp.chain(n_links=4, device="cpu", dtype=F64),
    "double_pendulum": lambda: tp.double_pendulum(device="cpu", dtype=F64),
}


def _phase(ex, batch=32, seed=2):
    rng = np.random.default_rng(seed)
    n = ex.n
    q = ex.init_config.q.numpy() + 0.01 * rng.standard_normal((batch, n))
    p = 0.05 * rng.standard_normal((batch, n))
    return phase_from_numpy(q, p, device="cpu", dtype=F64)


@pytest.mark.parametrize("case", sorted(PORT_CASES))
def test_plain_version_matches_library_leapfrog(case):
    """At converged (3,2) iterations the fused step and the library leapfrog
    have the same fixed points: they agree to float64 rounding."""
    ex = PORT_CASES[case]()
    ph = _phase(ex)
    lib = tp.make_stepper(ex.system, "leapfrog", iters=(3, 2))
    fus = tp.make_stepper(ex.system, "leapfrog_fused", iters=(3, 2))
    dt = torch.tensor(1e-3, dtype=F64)
    cl, cf = lib.init(ph), fus.init(ph)
    for _ in range(2):
        cl, cf = lib.step(cl, dt), fus.step(cf, dt)
    a, b = lib.extract(cl), fus.extract(cf)
    _close(a.q, b.q, 1e-12)
    _close(a.p, b.p, 1e-12)


#: The chain at the reference's default (dense, n = 20: ``leapfrog_fused``
#: on ``chain()``) and its stress chain's semiseparable form (n = 40),
#: which the card runs on ``csrc/fused_step.cu``'s variants 3 and 4:
#: name → (n, solver).
REFERENCE_LIBRARY_CASES = {"chain20-dense": (20, "dense"),
                           "chain40-semiseparable": (40, "semiseparable")}


@pytest.mark.parametrize("case", sorted(REFERENCE_LIBRARY_CASES))
def test_plain_version_matches_reference_library_leapfrog(case):
    """The port's plain fused step against the reference's library
    leapfrog on the same chain and inputs: at converged (3,2) iterations
    both reach the same fixed points, float64, two steps, 1e-12."""
    n, solver = REFERENCE_LIBRARY_CASES[case]
    jex = jmodels.chain(n_links=n, fused_solver=solver)
    tsys = tp.chain(n_links=n, fused_solver=solver, device="cpu", dtype=F64).system
    tsys = tsys.replace_params(params_from_numpy(
        {k: np.asarray(v) for k, v in jex.system.params.items()}, device="cpu", dtype=F64))
    rng = np.random.default_rng(21)
    q = np.asarray(jex.init_config.q) + 0.01 * rng.standard_normal((16, n))
    p = 0.05 * rng.standard_normal((16, n))
    jst = j_make_stepper(jex.system, "leapfrog", iters=(3, 2))
    tst = tp.make_stepper(tsys, "leapfrog_fused", iters=(3, 2))
    jc = jst.init(JPhase(jnp.asarray(q), jnp.asarray(p)))
    tc = tst.init(phase_from_numpy(q, p, device="cpu", dtype=F64))
    for _ in range(2):
        jc = jst.step(jc, jnp.asarray(1e-3))
        tc = tst.step(tc, torch.tensor(1e-3, dtype=F64))
    want, got = jst.extract(jc), tst.extract(tc)
    _close(want.q, got.q, 1e-12)
    _close(want.p, got.p, 1e-12)


@pytest.mark.parametrize("case", ["chain5-semiseparable", "double_pendulum"])
def test_block_equals_single_steps_bitwise(case):
    """A steps_per_call=5 block carries the end-of-step factor and aux to
    the next step; at iters_q ≥ 1 (uncompensated, float64) that factor is
    computed at exactly the next step's q₀, so the block equals five
    separate steps bitwise."""
    ex = PORT_CASES[case]()
    ph = _phase(ex)
    one = tp.make_stepper(ex.system, "leapfrog_fused", iters=(3, 1))
    multi = tp.make_stepper(ex.system, "leapfrog_fused", iters=(3, 1), steps_per_call=5)
    assert multi.substeps == 5
    dt = torch.tensor(1e-3, dtype=F64)
    c1, cm = one.init(ph), multi.init(ph)
    for _ in range(5):
        c1 = one.step(c1, dt)
    cm = multi.step(cm, dt)
    assert torch.equal(c1, cm)


def test_any_batch_size_and_layout():
    """No tile multiple: any B runs, and the carry is (n_sv, n, B) batch-minor."""
    ex = tp.chain(n_links=3, fused_solver="semiseparable", device="cpu", dtype=F64)
    st = tp.make_stepper(ex.system, "leapfrog_fused", iters=(2, 0), compensated=True)
    ph = _phase(ex, batch=7)
    carry = st.init(ph)
    assert carry.shape == (6, 3, 7) and carry.is_contiguous()
    out = st.extract(st.step(carry, torch.tensor(1e-3, dtype=F64)))
    assert out.q.shape == (7, 3) and bool(torch.isfinite(out.q).all())


# ----------------------------------------------------------------------
# What the wrapper refuses
# ----------------------------------------------------------------------


def test_requires_grad_inputs_raise():
    """Inputs that need a gradient no longer raise: a carry that requires
    grad differentiates, and masses that do make the table a shared
    run-time ``(L,)`` one that rides the carry.  What still raises: a
    run-time table that is not handed over as ``coef=``."""
    ex = tp.chain(n_links=3, fused_solver="semiseparable", device="cpu", dtype=F64)
    st = tp.make_stepper(ex.system, "leapfrog_fused", iters=(2, 0))
    carry = st.init(_phase(ex, batch=4)).requires_grad_(True)
    (g,) = torch.autograd.grad(st.step(carry, 1e-3).sum(), carry)
    assert g.shape == carry.shape and bool(torch.isfinite(g).all())
    grad_sys = ex.system.to()
    grad_sys.params = dict(grad_sys.params,
                           masses=grad_sys.params["masses"].clone().requires_grad_(True))
    gst = tp.make_stepper(grad_sys, "leapfrog_fused", iters=(2, 0))
    state, table = gst.init(_phase(ex, batch=4))
    assert table.shape == (9,) and table.requires_grad
    forms = grad_sys.fused_forms(grad_sys)
    assert forms.consts is None
    with pytest.raises(ValueError, match=r"need their \(L, B\) or \(L,\)"):
        t_step.fused_step(forms, state, 1e-3, iters=(2, 0), compensated=False)


def _grad_phase(n, batch=64, seed=0):
    """The reference test's ``ph4`` at another batch size: q near 0.5, small p."""
    rng = np.random.default_rng(seed)
    return 0.5 + 0.01 * rng.standard_normal((batch, n)), 0.01 * rng.standard_normal((batch, n))


def _j_library_loss(jsys, q0, p0, steps):
    c = j_make_stepper(jsys, "leapfrog", iters=(3, 1))
    carry = c.init(JPhase(q0, p0))
    for _ in range(steps):
        carry = c.step(carry, jnp.float64(1e-3))
    ph = c.extract(carry)
    return jnp.sum(ph.q ** 2) + jnp.sum(ph.p * ph.q)


def test_grad_matches_library_leapfrog():
    """The gradient through the fused step (its backward replays the plain
    version) of a final-state loss equals the library leapfrog's, which
    differentiates through the K2 entries, and ``jax.grad`` of the
    reference's library leapfrog — through a 2-step call that carries the
    factor (``tests/test_pallas_step.py``'s ``test_grad_matches_library_leapfrog``)."""
    ex = tp.chain(n_links=4, device="cpu", dtype=F64)
    q0, p0 = _grad_phase(4)
    fus = tp.make_stepper(ex.system, "leapfrog_fused", iters=(3, 1), steps_per_call=2)
    lib = tp.make_stepper(ex.system, "leapfrog", iters=(3, 1))

    def loss(st, calls):
        q, p = torch.tensor(q0, requires_grad=True), torch.tensor(p0, requires_grad=True)
        carry = st.init(tp.Phase(q, p))
        for _ in range(calls):
            carry = st.step(carry, 1e-3)
        ph = st.extract(carry)
        return torch.autograd.grad(torch.sum(ph.q ** 2) + torch.sum(ph.p * ph.q), (q, p))

    got, lib_g = loss(fus, 1), loss(lib, 2)
    jsys = jmodels.chain(n_links=4).system
    want = jax.grad(_j_library_loss, argnums=(1, 2))(jsys, jnp.asarray(q0), jnp.asarray(p0), 2)
    for g, l, w in zip(got, lib_g, want):
        np.testing.assert_allclose(g.numpy(), l.numpy(), rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9, atol=1e-12)


def test_grad_wrt_masses_through_fused():
    """Masses that need a gradient ride the fused step's shared run-time
    table; the gradient equals ``jax.grad`` of the reference's library
    leapfrog and a central finite difference."""
    ex = tp.chain(n_links=4, device="cpu", dtype=F64)
    q0, p0 = _grad_phase(4, seed=1)

    def loss(masses):
        sysb = ex.system.replace_params(dict(ex.system.params, masses=masses))
        st = tp.make_stepper(sysb, "leapfrog_fused", iters=(3, 1))
        carry = st.step(st.init(tp.Phase(torch.tensor(q0), torch.tensor(p0))), 1e-3)
        return torch.sum(st.extract(carry).q ** 2)

    m0 = torch.ones(4, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(m0), m0)
    jsys = jmodels.chain(n_links=4).system

    def j_loss(masses):
        sysb = jsys.replace_params(dict(jsys.params, masses=masses))
        c = j_make_stepper(sysb, "leapfrog", iters=(3, 1))
        return jnp.sum(c.extract(c.step(c.init(JPhase(jnp.asarray(q0), jnp.asarray(p0))),
                                        jnp.float64(1e-3))).q ** 2)

    want = jax.grad(j_loss)(jnp.ones(4))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-9, atol=1e-15)
    eps = 1e-5
    e = torch.zeros(4, dtype=F64)
    e[1] = eps
    with torch.no_grad():
        fd = (loss(m0 + e) - loss(m0 - e)) / (2 * eps)
    np.testing.assert_allclose(float(g[1]), float(fd), rtol=5e-3)


def test_kernel_argument_checks():
    """The kernel wrapper's validation, called with a device string so that
    no card is needed: a size no hand-written kernel has (n = 7, dense
    n = 12) goes to the kernel generated from the forms; another dtype, a
    bad state or the CPU is refused."""
    on20 = t_step.serial_chain_forms_on([1.0] * 20, [1.0] * 20, 5.0)
    t_step.check_kernel_args("cuda", torch.float32, on20, (6, 20, 1000))
    t_step.check_kernel_args("cuda:0", torch.float64, on20, (4, 20, 3))
    on7 = t_step.serial_chain_forms_on([1.0] * 7, [1.0] * 7, 5.0)
    dense12 = t_step.serial_chain_forms([1.0] * 12, [1.0] * 12, 5.0)
    for forms in (on7, dense12):
        assert t_step._kernel_key(forms) not in t_step.KERNEL_INSTANTIATIONS
        assert t_step.check_kernel_args("cuda", torch.float32, forms,
                                        (6, forms.n, 1000)) == (1.0,)
    with pytest.raises(ValueError, match="float32 or float64"):
        t_step.check_kernel_args("cuda", torch.float16, on20, (6, 20, 1000))
    with pytest.raises(ValueError, match="state"):
        t_step.check_kernel_args("cuda", torch.float32, on20, (5, 20, 1000))
    with pytest.raises(ValueError, match="CUDA"):
        t_step.check_kernel_args("cpu", torch.float32, on20, (6, 20, 1000))
    assert ("serial_chain_on", 20, 60) in t_step.KERNEL_INSTANTIATIONS
    assert ("serial_chain", 2, 6) in t_step.KERNEL_INSTANTIATIONS
