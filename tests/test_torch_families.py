"""The port's bundled model families (spherical pendulum, two-body, room,
spring, ellipse, Bézier) against the JAX package, on the CPU.

Each family is a model (its library system: coordinate map, potential,
parameters) with closed forms for the fused whole-step leapfrog.  The same
inputs, made with numpy from a seed, go through both packages in float64:
the library systems agree to 1e-12, the closed forms entry by entry to
1e-13 (relative to the entry's magnitude where it exceeds 1), and the port's
plain fused step against the reference's fused kernel in interpret mode as
``tests/test_torch_fused_step.py`` runs it.
"""

from math import comb

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hamilton_tpu import mechanics as jmech
from hamilton_tpu import models as jmodels
from hamilton_tpu.integrators.fixed import make_stepper as j_make_stepper
from hamilton_tpu.ops import pallas_step as j_step
from hamilton_tpu.state import Phase as JPhase

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import mechanics as tmech
from hamilton_tpu_torch.convert import params_from_numpy, phase_from_numpy
from hamilton_tpu_torch.ops import fused_step as t_step

from test_torch_fused_step import FUSED_TOL, TILE, _tiles_to_members

F64 = torch.float64
B = 16
LINEAR = [(-1.0, -1.0), (1.0, 1.0)]  # a 2-point Bézier: degree 1, no B''
THREE_POINTS = [(-1.0, -1.0), (0.0, 1.0), (1.0, -1.0)]  # degree 2: not instantiated

# name → (JAX example, port example factory, q center, q spread)
FAMILIES = {
    "spherical": (jmodels.spherical_pendulum, tp.spherical_pendulum, [1.0, 0.3], 0.3),
    "two_body": (jmodels.two_body, tp.two_body, [2.0, 0.1], 0.3),
    "room": (jmodels.room, tp.room, [-1.0, 0.25], 0.5),
    "spring": (jmodels.spring, tp.spring, [0.2, 0.1, 0.3], 0.3),
    "ellipse": (jmodels.ellipse, tp.ellipse, [2.0], 0.5),
    "bezier": (jmodels.bezier, tp.bezier, [0.5], 0.3),
    "bezier2": (lambda: jmodels.bezier(LINEAR),
                lambda **kw: tp.bezier(LINEAR, **kw), [0.5], 0.3),
}


def _pair(name, dtype=F64):
    """The reference's example and the port's, the port's params carried
    across from the reference's with ``params_from_numpy``."""
    jex = FAMILIES[name][0]()
    tex = FAMILIES[name][1](device="cpu", dtype=dtype)
    tsys = tex.system
    if jex.system.params is not None:
        tsys = tsys.replace_params(params_from_numpy(
            {k: np.asarray(v) for k, v in jex.system.params.items()},
            device="cpu", dtype=dtype,
        ))
    return jex, tex, tsys


def _q(name, batch, seed=0, spread=None):
    center, scale = FAMILIES[name][2], FAMILIES[name][3]
    rng = np.random.default_rng(seed)
    scale = scale if spread is None else spread
    return np.asarray(center) + scale * rng.standard_normal((batch, len(center)))


def _close(a, b, atol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


def _rel_close(a, b, tol):
    scale = max(1.0, float(np.abs(np.asarray(a)).max()))
    _close(a, b, tol * scale)


@pytest.fixture(params=sorted(FAMILIES))
def family(request):
    return request.param


# ----------------------------------------------------------------------
# The library systems
# ----------------------------------------------------------------------


def test_library_system(family):
    """J, ∇U, U and H of each family's library system, float64, 1e-12."""
    jex, _, tsys = _pair(family)
    q = _q(family, B)
    p = np.random.default_rng(1).standard_normal(q.shape)
    jq, tq = jnp.asarray(q), torch.as_tensor(q)
    _close(jmech._jacobian(jex.system, jq), tmech._jacobian(tsys, tq), 1e-12)
    _close(jmech._grad_u(jex.system, jq), tmech._grad_u(tsys, tq), 1e-12)
    _close(jmech.pe(jex.system, jq), tmech.pe(tsys, tq), 1e-12)
    _close(jmech.hamiltonian(jex.system, JPhase(jq, jnp.asarray(p))),
           tmech.hamiltonian(tsys, phase_from_numpy(q, p, device="cpu", dtype=F64)), 1e-12)


def test_initial_phase_and_registry(family):
    """The examples' initial phases agree, and ``get_example`` builds each
    registered model by its CLI name."""
    jex, tex, _ = _pair(family)
    _close(jex.init_phase.q, tex.init_phase.q, 1e-15)
    _close(jex.init_phase.p, tex.init_phase.p, 1e-12)
    assert set(tp.REGISTRY) == set(jmodels.REGISTRY)
    name = {"spherical": "spherical", "two_body": "twobody"}.get(family, family)
    if name in tp.REGISTRY:
        ex = tp.get_example(name, device="cpu", dtype=F64)
        assert ex.name == jmodels.get_example(name).name


# ----------------------------------------------------------------------
# The closed forms, entry by entry (float64)
# ----------------------------------------------------------------------


def _fams(family):
    jex, _, tsys = _pair(family)
    jforms = jex.system.fused_forms(jex.system)
    tforms = tsys.fused_forms(tsys)
    jfam = jforms.make(jforms.const_accessors(), j_step.FM_JNP)
    tfam = tforms.make(tforms.const_accessors(), t_step.FM_TORCH)
    return jforms, tforms, jfam, tfam


def test_forms_declarations(family):
    jforms, tforms, _, _ = _fams(family)
    assert (tforms.name, tforms.n, tforms.n_aux, tforms.coef_lens) == (
        jforms.name, jforms.n, jforms.n_aux, jforms.coef_lens)
    assert tforms.consts == jforms.consts


def test_forms_entries(family):
    """aux, every K entry (j ≤ i), ∂H/∂q and U on random member columns."""
    jforms, tforms, jfam, tfam = _fams(family)
    n = tforms.n
    q = _q(family, 64, seed=2).T
    w = np.random.default_rng(3).standard_normal((n, 64))
    jq, tq = [jnp.asarray(r) for r in q], [torch.as_tensor(r) for r in q]
    jw, tw = [jnp.asarray(r) for r in w], [torch.as_tensor(r) for r in w]
    ja, ta = jfam.aux(jq), tfam.aux(tq)
    assert len(ja) == len(ta) == tforms.n_aux
    for x, y in zip(ja, ta):
        _rel_close(x, y, 1e-13)
    jk, tk = jfam.k_at(ja, jq), tfam.k_at(ta, tq)
    for i in range(n):
        for j in range(i + 1):
            _rel_close(np.broadcast_to(jk(i, j), (64,)), torch.broadcast_to(tk(i, j), (64,)),
                       1e-13)
    for x, y in zip(jfam.dhdq(ja, jq, jw), tfam.dhdq(ta, tq, tw)):
        _rel_close(np.broadcast_to(x, (64,)), torch.broadcast_to(y, (64,)), 1e-13)
    _rel_close(jfam.potential(ja, jq), tfam.potential(ta, tq), 1e-13)


def test_bezier_kernel_table_folds_the_binomials():
    """The shared kernel table holds each derivative control point times its
    Bernstein binomial, folded in double as the shared forms fold them."""
    system = tp.bezier(device="cpu", dtype=F64).system
    forms = system.fused_forms(system)
    flat = forms.consts[0]
    want = [comb(3, k // 2) * v for k, v in enumerate(flat[:8])]
    want += [comb(2, k // 2) * v for k, v in enumerate(flat[8:])]
    assert forms.kernel_consts == tuple(want)
    assert t_step.coef_table(forms, "cpu", F64).tolist() == want


# ----------------------------------------------------------------------
# The plain version against the reference's fused kernel (interpret mode)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("family,dtype_name", [(f, "float64") for f in sorted(FAMILIES)]
                         + [("spherical", "float32"), ("spring", "float32")])
def test_plain_version_matches_reference_kernel(family, dtype_name):
    """One spc=5 call of the (2,0) Kahan stepper on 1024 members: float64 to
    1e-13, float32 within the chain's tolerances."""
    jex, _, tsys = _pair(family, getattr(torch, dtype_name))
    jsys = jax.tree_util.tree_map(lambda a: a.astype(dtype_name), jex.system)
    rng = np.random.default_rng(4)
    q = _q(family, TILE, seed=5, spread=0.05).astype(dtype_name)
    p = (0.05 * rng.standard_normal(q.shape)).astype(dtype_name)
    dt = 1e-3
    jst = j_make_stepper(jsys, "leapfrog_fused", iters=(2, 0), compensated=True,
                         steps_per_call=5)
    tst = tp.make_stepper(tsys, "leapfrog_fused", iters=(2, 0), compensated=True,
                          steps_per_call=5)
    with pltpu.force_tpu_interpret_mode():
        jc = jst.step(jst.init(JPhase(jnp.asarray(q), jnp.asarray(p))),
                      jnp.asarray(dt, dtype_name))
        jc = [_tiles_to_members(t) for t in jc]
    tdtype = getattr(torch, dtype_name)
    tc = tst.step(tst.init(phase_from_numpy(q, p, device="cpu", dtype=tdtype)),
                  torch.tensor(dt, dtype=tdtype))
    assert tc.shape == (len(jc), tsys.n, TILE)
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
# The plain version against the library leapfrog, sweeps, invariants
# ----------------------------------------------------------------------


def _phase(family, batch=32, seed=6):
    q = _q(family, batch, seed=seed, spread=0.05)
    p = 0.05 * np.random.default_rng(seed + 1).standard_normal(q.shape)
    return phase_from_numpy(q, p, device="cpu", dtype=F64)


def test_plain_version_matches_library_leapfrog(family):
    """At converged (3,2) iterations the fused step and the port's library
    leapfrog have the same fixed points: float64 rounding over 2 steps."""
    _, _, tsys = _pair(family)
    ph = _phase(family)
    lib = tp.make_stepper(tsys, "leapfrog", iters=(3, 2))
    fus = tp.make_stepper(tsys, "leapfrog_fused", iters=(3, 2))
    dt = torch.tensor(1e-3, dtype=F64)
    cl, cf = lib.init(ph), fus.init(ph)
    for _ in range(2):
        cl, cf = lib.step(cl, dt), fus.step(cf, dt)
    a, b = lib.extract(cl), fus.extract(cf)
    _close(a.q, b.q, 1e-12)
    _close(a.p, b.p, 1e-12)


def test_two_body_sweep_matches_reference_library():
    """Per-member (m1, m2) ride the per-member table of the plain fused step
    and agree with the reference's library leapfrog under the same params."""
    rng = np.random.default_rng(9)
    params = {"m1": 4.0 + rng.random(32), "m2": 0.3 + 0.3 * rng.random(32)}
    jex, _, tsys = _pair("two_body")
    jsys = jex.system.replace_params({k: jnp.asarray(v) for k, v in params.items()})
    tsys = tsys.replace_params(params_from_numpy(params, device="cpu", dtype=F64))
    ph = _phase("two_body")
    jst = j_make_stepper(jsys, "leapfrog", iters=(3, 2))
    tst = tp.make_stepper(tsys, "leapfrog_fused", iters=(3, 2))
    jc = jst.init(JPhase(jnp.asarray(ph.q.numpy()), jnp.asarray(ph.p.numpy())))
    tc = tst.init(ph)
    assert tc[1].shape == (2, 32)  # the (L, B) table rides the carry
    jstep = jax.jit(jst.step)
    for _ in range(2):
        jc, tc = jstep(jc, jnp.float64(1e-3)), tst.step(tc, torch.tensor(1e-3, dtype=F64))
    ja, ta = jst.extract(jc), tst.extract(tc)
    _close(ja.q, ta.q, 1e-12)
    _close(ja.p, ta.p, 1e-12)


def test_spherical_conserves_azimuthal_momentum():
    """∂H/∂φ is a structural zero, so p_φ is kept to the last bit over a
    5-step call."""
    _, _, tsys = _pair("spherical")
    ph = _phase("spherical")
    fus = tp.make_stepper(tsys, "leapfrog_fused", iters=(2, 1), steps_per_call=5)
    out = fus.extract(fus.step(fus.init(ph), torch.tensor(1e-3, dtype=F64)))
    assert torch.equal(out.p[:, 1], ph.p[:, 1])
    assert not torch.equal(out.p[:, 0], ph.p[:, 0])


# ----------------------------------------------------------------------
# What the kernel wrapper takes and refuses (no card needed)
# ----------------------------------------------------------------------


def test_kernel_instantiations_accepted_and_refused(family):
    """Every bundled family is instantiated, in both dtypes, with Kahan
    residuals or without; a 3-point Bézier and a user's own family are taken
    too, by the generated kernel.  What is refused: another dtype, a state
    of the wrong shape, and more than five composition weights."""
    _, _, tsys = _pair(family)
    forms = tsys.fused_forms(tsys)
    for dtype in (torch.float32, torch.float64):
        for n_sv in (4, 6):
            assert t_step.check_kernel_args("cuda", dtype, forms, (n_sv, forms.n, 300)) == (1.0,)
    three = tp.bezier(THREE_POINTS, device="cpu", dtype=F64).system
    three_forms = three.fused_forms(three)
    assert t_step._kernel_key(three_forms) not in t_step.KERNEL_INSTANTIATIONS
    assert t_step.check_kernel_args("cuda", torch.float32, three_forms, (6, 1, 8)) == (1.0,)
    user = t_step.FusedForms(n=forms.n, n_aux=forms.n_aux, coef_lens=forms.coef_lens,
                             consts=forms.consts, make=forms.make, name="elastic_pendulum",
                             arrays_fn=forms.arrays_fn)
    assert t_step.check_kernel_args("cuda", torch.float64, user, (4, forms.n, 8)) == (1.0,)
    for f in (forms, user):
        with pytest.raises(ValueError, match="float32 or float64"):
            t_step.check_kernel_args("cuda", torch.float16, f, (4, forms.n, 8))
        with pytest.raises(ValueError, match="state"):
            t_step.check_kernel_args("cuda", torch.float32, f, (5, forms.n, 8))
        with pytest.raises(ValueError, match="1 to 5 weights"):
            t_step.check_kernel_args("cuda", torch.float32, f, (4, forms.n, 8),
                                     composition=(0.2,) * 6)

