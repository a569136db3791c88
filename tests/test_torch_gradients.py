"""Gradients through the port's trajectories against ``jax.grad`` on the CPU.

The mirror of ``tests/test_gradients.py``: reverse-mode differentiation
through ``evolve_ham_fixed`` — the leapfrog's fixed-point iterations, its
batched SPD solves (the K2 entries' backwards), the VJP-of-JVP force and
``to_phase`` — in float64.  The port has no ``gauss4`` yet (ROADMAP M11), so
both packages run the ``leapfrog`` where the JAX test uses its default.  The
same inputs go through both; the gradients agree to 1e-9 relative, and to a
central finite difference at the JAX tests' own rtol.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamilton_tpu import Config as JConfig
from hamilton_tpu import Phase as JPhase
from hamilton_tpu import evolve_ham_fixed as j_evolve_ham_fixed
from hamilton_tpu import to_phase as j_to_phase
from hamilton_tpu.models import double_pendulum as j_double_pendulum
from hamilton_tpu.models import pendulum as j_pendulum

import hamilton_tpu_torch as tp

F64 = torch.float64
RTOL = 1e-9
JDP = j_double_pendulum()


def _dp():
    return tp.double_pendulum(device="cpu", dtype=F64)


def _t_final_q0(system, ph0, **kw):
    kw.setdefault("iters", 3)
    kw.setdefault("method", "leapfrog")
    return tp.evolve_ham_fixed(system, ph0, 0.01, 30, emit_every=30, **kw).q[-1, ..., 0]


def _j_final_q0(system, ph0, **kw):
    out = j_evolve_ham_fixed(system, ph0, 0.01, 30, emit_every=30, iters=3,
                             method="leapfrog", **kw)
    return out.q[-1, ..., 0]


def _rel_close(want, got, rtol=RTOL):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), (want, got)


def test_grad_wrt_initial_momentum_matches_fd():
    ex = _dp()
    q0, p0 = ex.init_phase.q, ex.init_phase.p
    p = p0.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(_t_final_q0(ex.system, tp.Phase(q0, p)), p)
    jg = jax.grad(lambda pp: _j_final_q0(JDP.system, JPhase(JDP.init_phase.q, pp)))(
        JDP.init_phase.p)
    _rel_close(jg, g.numpy())
    eps = 1e-6
    e0 = torch.zeros_like(p0)
    e0[0] = eps
    with torch.no_grad():
        fd = (_t_final_q0(ex.system, tp.Phase(q0, p0 + e0))
              - _t_final_q0(ex.system, tp.Phase(q0, p0 - e0))) / (2 * eps)
    np.testing.assert_allclose(float(g[0]), float(fd), rtol=1e-5)


@pytest.mark.parametrize("method", ["leapfrog", "leapfrog_fused", "yoshida4_fused",
                                    "suzuki4_fused"])
def test_grad_finite_all_methods(method):
    """Every ported method differentiates (the fused ones through the fused
    step's replay); the library leapfrog's gradient is JAX's."""
    ex = _dp()
    ph0 = ex.init_phase
    batched = method.endswith("_fused")  # the fused steppers take (B, n)
    q0 = ph0.q.expand(1, 2).clone() if batched else ph0.q.clone()
    p0 = ph0.p.expand(1, 2) if batched else ph0.p
    q = q0.requires_grad_(True)
    out = _t_final_q0(ex.system, tp.Phase(q, p0), method=method)
    (g,) = torch.autograd.grad(out.sum(), q)
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    jg = jax.grad(lambda qq: _j_final_q0(JDP.system, JPhase(qq, JDP.init_phase.p)))(
        JDP.init_phase.q)
    if method == "leapfrog":
        _rel_close(jg, g.numpy())
    elif method == "leapfrog_fused":
        # (3, 3) iterations: the same fixed points as the library leapfrog
        _rel_close(jg, g.numpy()[0], rtol=1e-6)


@pytest.mark.parametrize("iters", [(2, 0), (3, 1)], ids=["gauss-seidel-2-0", "exact-3-1"])
def test_grad_through_kahan_and_warm_starts(iters):
    """The library leapfrog's Kahan carries and warm starts (the force and
    velocity-derivative estimates it carries between steps) pass gradients:
    the gradient equals ``jax.grad`` of the reference's with the same
    options."""
    ex = _dp()
    kw = dict(method="leapfrog", iters=iters, compensated=True)
    q = ex.init_phase.q.clone().requires_grad_(True)
    out = tp.evolve_ham_fixed(ex.system, tp.Phase(q, ex.init_phase.p), 0.01, 30,
                              emit_every=30, **kw)
    (g,) = torch.autograd.grad(out.q[-1, 0], q)
    jg = jax.grad(lambda qq: j_evolve_ham_fixed(JDP.system, JPhase(qq, JDP.init_phase.p),
                                                0.01, 30, emit_every=30, **kw).q[-1, 0])(
        JDP.init_phase.q)
    _rel_close(jg, g.numpy())


def test_remat_matches_no_remat():
    ex = _dp()
    grads = []
    for remat in (False, True):
        q = ex.init_phase.q.clone().requires_grad_(True)
        out = _t_final_q0(ex.system, tp.Phase(q, ex.init_phase.p), remat=remat)
        grads.append(torch.autograd.grad(out, q)[0])
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-12, atol=0)


def test_grad_wrt_params():
    """A mass that needs a gradient flows through ``to_phase`` (whose
    Jacobian and inertia read it), the mass matrix and the potential."""
    ex = _dp()

    def t_loss(m2):
        sysm = ex.system.replace_params({"m1": torch.tensor(1.0, dtype=F64), "m2": m2})
        ph0 = tp.to_phase(sysm, ex.init_config)
        out = tp.evolve_ham_fixed(sysm, ph0, 0.01, 30, emit_every=30, iters=3,
                                  method="leapfrog")
        return torch.sum(out.q[-1] ** 2)

    def j_loss(m2):
        sysm = JDP.system.replace_params({"m1": jnp.asarray(1.0), "m2": m2})
        ph0 = j_to_phase(sysm, JDP.init_config)
        out = j_evolve_ham_fixed(sysm, ph0, 0.01, 30, emit_every=30, iters=3,
                                 method="leapfrog")
        return jnp.sum(out.q[-1] ** 2)

    m2 = torch.tensor(1.0, dtype=F64, requires_grad=True)
    (g,) = torch.autograd.grad(t_loss(m2), m2)
    assert bool(torch.isfinite(g)) and float(g) != 0.0
    _rel_close(jax.grad(j_loss)(jnp.asarray(1.0)), g.numpy())
    eps = 1e-6
    with torch.no_grad():
        fd = (t_loss(torch.tensor(1.0 + eps, dtype=F64))
              - t_loss(torch.tensor(1.0 - eps, dtype=F64))) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-4)


def test_tiny_shooting_optimization():
    """Fit an initial angular velocity so the pendulum reaches a target
    angle: ten gradient-descent steps, each gradient JAX's."""
    ex = tp.pendulum(theta0=0.0, omega0=0.5, device="cpu", dtype=F64)
    jex = j_pendulum(theta0=0.0, omega0=0.5)
    target = 0.6

    def t_loss(omega0):
        ph0 = tp.to_phase(ex.system, tp.Config(torch.zeros(1, dtype=F64), omega0[None]))
        out = tp.evolve_ham_fixed(ex.system, ph0, 0.02, 25, emit_every=25, iters=3,
                                  method="leapfrog")
        return (out.q[-1, 0] - target) ** 2

    def j_loss(omega0):
        ph0 = j_to_phase(jex.system, JConfig(jnp.array([0.0]), jnp.stack([omega0])))
        out = j_evolve_ham_fixed(jex.system, ph0, 0.02, 25, emit_every=25, iters=3,
                                 method="leapfrog")
        return (out.q[-1, 0] - target) ** 2

    j_lg = jax.jit(jax.value_and_grad(j_loss))
    omega = torch.tensor(0.5, dtype=F64)
    l0 = None
    for _ in range(10):
        w = omega.clone().requires_grad_(True)
        val = t_loss(w)
        (g,) = torch.autograd.grad(val, w)
        jval, jg = j_lg(jnp.asarray(float(omega)))
        _rel_close(jg, g.numpy())
        l0 = float(val) if l0 is None else l0
        omega = omega - 0.5 * g
    with torch.no_grad():
        assert float(t_loss(omega)) < l0 * 0.05


def test_grad_through_batched_evolution():
    """Gradients flow through a batch of members (the batched K2 entries)."""
    ex = _dp()
    b = 4
    rng = np.random.default_rng(0)
    q0 = ex.init_phase.q.numpy() + 0.01 * rng.standard_normal((b, 2))
    p0 = np.tile(ex.init_phase.p.numpy(), (b, 1))

    q = torch.tensor(q0, requires_grad=True)
    out = tp.evolve_ham_fixed(ex.system, tp.Phase(q, torch.tensor(p0)), 0.01, 20,
                              emit_every=20, iters=3, method="leapfrog")
    (g,) = torch.autograd.grad(torch.sum(out.q[-1] ** 2), q)
    assert g.shape == (b, 2) and bool(torch.isfinite(g).all())

    def j_loss(qq):
        res = j_evolve_ham_fixed(JDP.system, JPhase(qq, jnp.asarray(p0)), 0.01, 20,
                                 emit_every=20, iters=3, method="leapfrog")
        return jnp.sum(res.q[-1] ** 2)

    _rel_close(jax.grad(j_loss)(jnp.asarray(q0)), g.numpy())


def test_evolve_ham_fixed_emission_and_refusals():
    """Emission every ``emit_every`` steps with the initial state first, as
    the reference's; its divisibility checks; the unported methods name
    ROADMAP M11."""
    ex = _dp()
    out = tp.evolve_ham_fixed(ex.system, ex.init_phase, 0.01, 12, method="leapfrog",
                              iters=3, emit_every=4)
    jout = j_evolve_ham_fixed(JDP.system, JDP.init_phase, 0.01, 12, method="leapfrog",
                              iters=3, emit_every=4)
    assert out.q.shape == (4, 2)
    np.testing.assert_allclose(np.asarray(jout.q), out.q.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(jout.p), out.p.numpy(), rtol=0, atol=1e-13)
    phb = tp.Phase(ex.init_phase.q.expand(3, 2).contiguous(),
                   ex.init_phase.p.expand(3, 2).contiguous())
    fused = tp.evolve_ham_fixed(ex.system, phb, 0.01, 12, method="leapfrog_fused",
                                iters=(3, 3), emit_every=4, steps_per_call=2)
    assert fused.q.shape == (4, 3, 2)
    np.testing.assert_allclose(out.q.numpy(), fused.q[:, 1].numpy(), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="not divisible"):
        tp.evolve_ham_fixed(ex.system, ex.init_phase, 0.01, 10, method="leapfrog",
                            emit_every=4)
    with pytest.raises(ValueError, match="kernel-call boundaries"):
        tp.evolve_ham_fixed(ex.system, phb, 0.01, 12, method="leapfrog_fused",
                            emit_every=4, steps_per_call=3)
    with pytest.raises(NotImplementedError, match="M11"):
        tp.evolve_ham_fixed(ex.system, ex.init_phase, 0.01, 12)


# ----------------------------------------------------------------------
# remat=True with tensors outside system.params
# ----------------------------------------------------------------------

_DP_Q0, _DP_P0 = np.array([1.0, 0.5]), np.array([0.3, -0.2])


def _dp_coords(lib):
    def coords(q):
        t1, t2 = q[0], q[1]
        return lib.stack([lib.sin(t1), 1.0 - lib.cos(t1), lib.sin(t1) + lib.sin(t2) / 2.0,
                          1.0 - lib.cos(t1) - lib.cos(t2) / 2.0])

    return coords


def _t_dp_loss(inertia, gravity, remat):
    """A double pendulum from ``mk_system_cart`` with the inertia tensor
    given and gravity captured by the potential; float64 leapfrog (3,2),
    dt = 1e-2, 10 steps; loss |q|² + |p|² of the final state."""
    system = tp.mk_system_cart(inertia, _dp_coords(torch),
                               lambda x: gravity * (x[1] + x[3]), device="cpu", dtype=F64, n=2)
    out = tp.evolve_ham_fixed(system, tp.Phase(torch.tensor(_DP_Q0), torch.tensor(_DP_P0)),
                              1e-2, 10, method="leapfrog", iters=(3, 2), emit_every=10,
                              remat=remat)
    return (out.q[-1] ** 2).sum() + (out.p[-1] ** 2).sum()


def _j_dp_loss(inertia, gravity):
    from hamilton_tpu import mk_system_cart as j_mk_system_cart

    system = j_mk_system_cart(inertia, _dp_coords(jnp), lambda x: gravity * (x[1] + x[3]), n=2)
    out = j_evolve_ham_fixed(system, JPhase(jnp.asarray(_DP_Q0), jnp.asarray(_DP_P0)), 1e-2, 10,
                             method="leapfrog", iters=(3, 2), emit_every=10)
    return (out.q[-1] ** 2).sum() + (out.p[-1] ** 2).sum()


@pytest.mark.parametrize("wrt", ["inertia", "gravity"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_remat_gradient_outside_params(wrt, remat):
    """``remat=True`` returns the gradient to tensors that are not in
    ``system.params`` — an inertia tensor given to ``mk_system_cart`` and a
    gravity the potential captures — equal to ``jax.grad`` of the
    reference's, float64, to 1e-10 relative."""
    inertia0, gravity0 = np.array([1.0, 1.0, 2.0, 2.0]), 5.0
    inertia = torch.tensor(inertia0, requires_grad=wrt == "inertia")
    gravity = torch.tensor(gravity0, dtype=F64, requires_grad=wrt == "gravity")
    (got,) = torch.autograd.grad(_t_dp_loss(inertia, gravity, remat),
                                 inertia if wrt == "inertia" else gravity)
    want = jax.grad(_j_dp_loss, argnums=0 if wrt == "inertia" else 1)(
        jnp.asarray(inertia0), jnp.asarray(gravity0))
    _rel_close(want, got.numpy(), rtol=1e-10)


def test_remat_raises_for_an_unreachable_dependency():
    """A tensor the step reads that needs a gradient but that the
    recomputation cannot reach (held by an object the capture walk does not
    enter) raises instead of dropping its gradient; with remat=False the
    gradient is there."""
    holder = type("Holder", (), {})()
    holder.g = torch.tensor(5.0, dtype=F64, requires_grad=True)
    system = tp.mk_system_cart(torch.ones(4, dtype=F64), _dp_coords(torch),
                               lambda x: holder.g * (x[1] + x[3]), device="cpu", dtype=F64, n=2)

    def loss(remat):
        out = tp.evolve_ham_fixed(system, tp.Phase(torch.tensor(_DP_Q0), torch.tensor(_DP_P0)),
                                  1e-2, 4, method="leapfrog", iters=(3, 2), emit_every=4,
                                  remat=remat)
        return (out.q[-1] ** 2).sum()

    (g,) = torch.autograd.grad(loss(False), holder.g)
    assert float(g) != 0.0
    with pytest.raises(RuntimeError, match="remat=True"):
        torch.autograd.grad(loss(True), holder.g)
