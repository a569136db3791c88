"""The hand-written CUDA kernels themselves (``hamilton_tpu_torch/csrc/
fused_step.cu``, ``csrc/chain_variants.cu``, ``csrc/family_step.cu``,
``csrc/user_family_step.cu`` around generated forms, ``csrc/batched_spd.cu``
and ``csrc/roofline_probes.cu``), and the gradients through them.

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
from hamilton_tpu_torch.examples import elastic_pendulum
from hamilton_tpu_torch.ops import batched_spd as bs
from hamilton_tpu_torch.ops import fused_codegen as cg
from hamilton_tpu_torch.ops import fused_step as t_step
from hamilton_tpu_torch.utils import roofline as rl

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


def _sweep_state(n, batch, dtype, card, iters, compensated, composition=(1.0,), seed=4):
    """A chain-n sweep (per-member masses and gravity) and its stepper's
    initial carry ``(state, table)``."""
    rng = np.random.default_rng(seed)
    ex = tp.chain(n_links=n, fused_solver="semiseparable", device=card, dtype=dtype)
    sysb = ex.system.replace_params(tp.params_from_numpy({
        "masses": 1.0 + 0.05 * rng.standard_normal((batch, n)),
        "lengths": np.ones((batch, n)),
        "gravity": 5.0 + 0.1 * rng.standard_normal(batch),
    }, device=card, dtype=dtype))
    q = 0.5 + 0.01 * rng.standard_normal((batch, n))
    p = 0.05 * rng.standard_normal((batch, n))
    forms = sysb.fused_forms(sysb)
    st = t_step.fused_stepper(forms, iters=iters, compensated=compensated,
                              composition=composition)
    return forms, st.init(tp.phase_from_numpy(q, p, device=card, dtype=dtype))


@pytest.mark.parametrize("n", [5, 20])
def test_per_member_kernel_matches_plain_version(card, n):
    """Per-member tables, float64 (2,0) with Kahan, a ragged batch, ten
    steps per launch: float64 rounding, as the shared-table test."""
    forms, (state, table) = _sweep_state(n, 300, torch.float64, card, (2, 0), True)
    assert forms.consts is None and table.shape == (3 * n, 300)
    kw = dict(iters=(2, 0), compensated=True, steps_per_call=10, coef=table)
    before = kernels.fused_step_launch.launches
    got = t_step.fused_step_kernel(forms, state, 5e-4, **kw)
    assert kernels.fused_step_launch.launches == before + 1
    want = t_step.fused_step_reference(forms, state, 5e-4, **kw)
    scale = torch.ones(state.shape[0], 1, 1, dtype=torch.float64, device=card)
    scale[-1] = 5e-4
    assert float(((got - want) * scale).abs().max()) < 1e-11


@pytest.mark.parametrize("swept", [False, True], ids=["shared", "per_member"])
@pytest.mark.parametrize("composition", [t_step.YOSHIDA4_COMPOSITION,
                                         t_step.SUZUKI4_COMPOSITION],
                         ids=["yoshida4", "suzuki4"])
def test_composition_kernel_matches_plain_version(card, composition, swept):
    """The composition weights by value, float64 (3,2), five steps per
    launch, chain-5: float64 rounding."""
    if swept:
        forms, (state, table) = _sweep_state(5, 300, torch.float64, card, (3, 2), False,
                                             composition)
    else:
        ex = tp.chain(n_links=5, fused_solver="semiseparable", device=card,
                      dtype=torch.float64)
        forms, state = _state(ex, (3, 2), False, 300, card)
        table = None
    kw = dict(iters=(3, 2), compensated=False, steps_per_call=5, composition=composition,
              coef=table)
    got = t_step.fused_step_kernel(forms, state, 1e-3, **kw)
    want = t_step.fused_step_reference(forms, state, 1e-3, **kw)
    scale = torch.ones(state.shape[0], 1, 1, dtype=torch.float64, device=card)
    scale[-1] = 1e-3
    assert float(((got - want) * scale).abs().max()) < 1e-11


def test_uninstantiated_size_raises_on_the_card(card):
    """A chain size no hand-written kernel is compiled for (n = 7) no longer
    raises: it runs on the kernel generated from the chain's forms (its own
    factor and solve, the float32 aux shift), equal to the plain version
    bit for bit."""
    ex = tp.chain(n_links=7, fused_solver="semiseparable", device=card, dtype=torch.float32)
    st = tp.make_stepper(ex.system, "leapfrog_fused", iters=(2, 0))
    carry = st.init(tp.Phase(ex.init_config.q.expand(4, 7).contiguous(),
                             torch.zeros(4, 7, device=card)))
    before = kernels.launch_counts()
    got = st.step(carry, 1e-3)
    after = kernels.launch_counts()
    assert after["user_family"] == before["user_family"] + 1
    assert after["fused_step"] == before["fused_step"]
    forms = ex.system.fused_forms(ex.system)
    want = t_step.fused_step_reference(forms, carry, 1e-3, iters=(2, 0), compensated=False)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------
# The chain's other forms (csrc/chain_variants.cu)
# ----------------------------------------------------------------------


def _chain_state(solver, n, card, dtype, iters, compensated, swept, composition=(1.0,),
                 batch=300, seed=6):
    """A chain-n example with ``solver``'s forms (per-member masses, lengths
    and gravity when ``swept``) and its stepper's initial carry."""
    rng = np.random.default_rng(seed)
    ex = tp.chain(n_links=n, fused_solver=solver, device=card, dtype=dtype)
    system = ex.system
    if swept:
        system = system.replace_params(tp.params_from_numpy({
            "masses": 1.0 + 0.05 * rng.standard_normal((batch, n)),
            "lengths": 1.0 + 0.1 * rng.random((batch, n)),
            "gravity": 5.0 + 0.1 * rng.standard_normal(batch),
        }, device=card, dtype=dtype))
    q = 0.5 + 0.05 * rng.standard_normal((batch, n))
    p = 0.3 * rng.standard_normal((batch, n))
    forms = system.fused_forms(system)
    st = t_step.fused_stepper(forms, iters=iters, compensated=compensated,
                              composition=composition)
    return system, forms, st.init(tp.phase_from_numpy(q, p, device=card, dtype=dtype))


@pytest.mark.parametrize("batch", [300, 1, 7, 16383])
@pytest.mark.parametrize("swept", [False, True], ids=["shared", "per_member"])
@pytest.mark.parametrize("solver,n", [("mobius", 20), ("mobius", 5), ("linv", 20),
                                      ("linv", 5), ("dense", 4)])
def test_chain_variant_kernel_matches_plain_version(card, solver, n, swept, batch):
    """float64 (2,0) Kahan and (3,2) and a Suzuki composition, ten steps per
    launch, ragged batches (not a multiple of a block's members or threads),
    shared and per-member tables: the kernel (no FMA contraction) agrees
    with its plain version to float64 rounding; L⁻¹ bit for bit."""
    for iters, comp, composition in (((2, 0), True, (1.0,)), ((3, 2), False, (1.0,)),
                                     ((2, 0), True, t_step.SUZUKI4_COMPOSITION)):
        _, forms, carry = _chain_state(solver, n, card, torch.float64, iters, comp, swept,
                                       composition, batch=batch)
        state, table = carry if swept else (carry, None)
        kw = dict(iters=iters, compensated=comp, steps_per_call=10, coef=table,
                  composition=composition)
        before = kernels.chain_variants_launch.launches
        got = t_step.fused_step_kernel(forms, state, 5e-4, **kw)
        assert kernels.chain_variants_launch.launches == before + 1
        want = t_step.fused_step_reference(forms, state, 5e-4, **kw)
        scale = torch.ones(state.shape[0], 1, 1, dtype=torch.float64, device=card)
        scale[-1] = 5e-4
        assert bool(torch.isfinite(got).all())
        assert float(((got - want) * scale).abs().max()) < 1e-11
        if solver == "linv":
            assert torch.equal(got, want)


@pytest.mark.parametrize("solver", ["mobius", "linv"])
def test_chain_variant_kernel_matches_library_leapfrog(card, solver):
    """chain-5 float64 (3,2): the same fixed points as the library leapfrog."""
    ex = tp.chain(n_links=5, fused_solver=solver, device=card, dtype=torch.float64)
    rng = np.random.default_rng(1)
    ph = tp.phase_from_numpy(0.5 + 0.01 * rng.standard_normal((100, 5)),
                             0.05 * rng.standard_normal((100, 5)), device=card,
                             dtype=torch.float64)
    lib = tp.make_stepper(ex.system, "leapfrog", iters=(3, 2))
    fus = tp.make_stepper(ex.system, "leapfrog_fused", iters=(3, 2), steps_per_call=2)
    dt = torch.tensor(1e-3, dtype=torch.float64)
    cl, cf = lib.init(ph), fus.step(fus.init(ph), dt)
    for _ in range(2):
        cl = lib.step(cl, dt)
    a, b = lib.extract(cl), fus.extract(cf)
    assert float((a.q - b.q).abs().max()) < 1e-12
    assert float((a.p - b.p).abs().max()) < 1e-12


def _fused_grads(device, solver, n):
    """Gradients of a final-state loss through one 3-step fused launch with
    respect to (q₀, p₀) and shared masses that need a gradient."""
    rng = np.random.default_rng(8)
    q0 = torch.tensor(0.5 + 0.05 * rng.standard_normal((64, n)), device=device,
                      requires_grad=True)
    p0 = torch.tensor(0.3 * rng.standard_normal((64, n)), device=device, requires_grad=True)
    masses = torch.tensor(1.0 + 0.1 * rng.random(n), device=device, requires_grad=True)
    ex = tp.chain(n_links=n, fused_solver=solver, device=device, dtype=torch.float64)
    system = ex.system.replace_params(dict(ex.system.params, masses=masses))
    st = tp.make_stepper(system, "leapfrog_fused", iters=(3, 1), steps_per_call=3)
    ph = st.extract(st.step(st.init(tp.Phase(q0, p0)), 1e-3))
    loss = (ph.q ** 2).sum() + (ph.p * ph.q).sum()
    return [g.cpu() for g in torch.autograd.grad(loss, (q0, p0, masses))]


@pytest.mark.parametrize("solver,n", [("semiseparable", 20), ("mobius", 5), ("linv", 5),
                                      ("dense", 4)])
def test_fused_gradient_kernel_matches_plain(card, solver, n):
    """The kernel-backed step (its forward the kernel, in its shared mode
    for the run-time masses) against the plain-backed one on the CPU: the
    backward replays the same plain version, so the gradients agree to
    float64 rounding."""
    before = kernels.launch_counts()
    got = _fused_grads(card, solver, n)
    after = kernels.launch_counts()
    assert sum(after.values()) - sum(before.values()) == 1
    want = _fused_grads("cpu", solver, n)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())


# ----------------------------------------------------------------------
# The model families' kernel (csrc/family_step.cu)
# ----------------------------------------------------------------------

# name → (example factory, q jitter scale)
FAMILIES = {
    "spherical": (tp.spherical_pendulum, 0.05),
    "two_body": (tp.two_body, 0.02),
    "room": (tp.room, 0.05),
    "spring": (tp.spring, 0.02),
    "ellipse": (tp.ellipse, 0.05),
    "bezier": (tp.bezier, 0.05),
    "bezier2": (lambda **kw: tp.bezier([(-1.0, -1.0), (1.0, 1.0)], **kw), 0.05),
}


def _family_state(name, card, dtype, iters, compensated, swept, composition=(1.0,)):
    """A family's forms and its stepper's initial carry on 300 members at the
    example's initial phase with jittered q; ``swept`` draws every parameter
    per member (5 % jitter), giving the per-member table."""
    make, scale = FAMILIES[name]
    ex = make(device=card, dtype=dtype)
    system = ex.system
    rng = np.random.default_rng(5)
    if swept:
        system = system.replace_params({
            k: v * torch.as_tensor(1.0 + 0.05 * rng.standard_normal((300,) + (1,) * v.ndim),
                                   device=card, dtype=dtype)
            for k, v in system.params.items()})
    ph0 = ex.init_phase
    q = ph0.q.cpu().numpy() + scale * rng.standard_normal((300, ex.n))
    p = ph0.p.cpu().numpy() + np.zeros((300, ex.n))
    forms = system.fused_forms(system)
    st = t_step.fused_stepper(forms, iters=iters, compensated=compensated,
                              composition=composition)
    return forms, st.init(tp.phase_from_numpy(q, p, device=card, dtype=dtype))


@pytest.mark.parametrize("name,swept", [(name, swept) for name in sorted(FAMILIES)
                                         for swept in (False, True)
                                         if not (swept and name == "room")])
def test_family_kernel_matches_plain_version(card, name, swept):
    """float64 (2,0) Kahan and (3,2), ten steps per launch, a ragged batch,
    shared and per-member tables (room has no parameters, so no per-member
    table): the family kernel agrees with its plain version to float64
    rounding."""
    for iters, comp in (((2, 0), True), ((3, 2), False)):
        forms, carry = _family_state(name, card, torch.float64, iters, comp, swept)
        state, table = carry if swept else (carry, None)
        kw = dict(iters=iters, compensated=comp, steps_per_call=10, coef=table)
        before = kernels.family_step_launch.launches
        got = t_step.fused_step_kernel(forms, state, 1e-3, **kw)
        assert kernels.family_step_launch.launches == before + 1
        want = t_step.fused_step_reference(forms, state, 1e-3, **kw)
        scale = torch.ones(state.shape[0], 1, 1, dtype=torch.float64, device=card)
        scale[-1] = 1e-3
        assert bool(torch.isfinite(got).all())
        assert float(((got - want) * scale).abs().max()) < 1e-11


def test_family_composition_kernel_matches_plain_version(card):
    forms, state = _family_state("spherical", card, torch.float64, (2, 0), True, False,
                                 t_step.SUZUKI4_COMPOSITION)
    kw = dict(iters=(2, 0), compensated=True, steps_per_call=5,
              composition=t_step.SUZUKI4_COMPOSITION)
    got = t_step.fused_step_kernel(forms, state, 1e-3, **kw)
    want = t_step.fused_step_reference(forms, state, 1e-3, **kw)
    scale = torch.ones(state.shape[0], 1, 1, dtype=torch.float64, device=card)
    scale[-1] = 1e-3
    assert float(((got - want) * scale).abs().max()) < 1e-11


def test_family_kernel_matches_library_leapfrog(card):
    """The spring (n = 3, dense K with a structural zero), float64 (3,2):
    the kernel and the library leapfrog agree over two steps."""
    _, state = _family_state("spring", card, torch.float64, (3, 2), False, False)
    ph = tp.Phase(state[0].T.contiguous(), state[1].T.contiguous())
    system = tp.spring(device=card, dtype=torch.float64).system
    lib = tp.make_stepper(system, "leapfrog", iters=(3, 2))
    fus = tp.make_stepper(system, "leapfrog_fused", iters=(3, 2))
    dt = torch.tensor(1e-3, dtype=torch.float64)
    cl, cf = lib.init(ph), fus.init(ph)
    for _ in range(2):
        cl, cf = lib.step(cl, dt), fus.step(cf, dt)
    a, b = lib.extract(cl), fus.extract(cf)
    assert float((a.q - b.q).abs().max()) < 1e-12
    assert float((a.p - b.p).abs().max()) < 1e-12


def test_uninstantiated_family_raises_on_the_card(card):
    """A 3-point Bézier is not in ``family_step.cu``: it runs on the
    generated kernel (never the family kernel), equal to the plain version
    bit for bit; a family whose forms cannot be generated raises before any
    launch."""
    ex = tp.bezier([(-1.0, -1.0), (0.0, 1.0), (1.0, -1.0)], device=card, dtype=torch.float32)
    st = tp.make_stepper(ex.system, "leapfrog_fused", iters=(2, 0))
    carry = st.init(tp.Phase(ex.init_config.q.expand(4, 1).contiguous(),
                             torch.zeros(4, 1, device=card)))
    before = kernels.launch_counts()
    got = st.step(carry, 1e-3)
    after = kernels.launch_counts()
    assert after["family_step"] == before["family_step"]
    assert after["user_family"] == before["user_family"] + 1
    forms = ex.system.fused_forms(ex.system)
    assert torch.equal(got, t_step.fused_step_reference(forms, carry, 1e-3, iters=(2, 0),
                                                        compensated=False))

    def make(at, fm):
        return t_step.FamilyFns(lambda q: (fm.sin(q[0]),),
                                lambda a, q: lambda i, j: fm.full(at[0](0), a[0]),
                                lambda a, q, w: [q[0] if at[0](0) > 0 else -q[0]])

    branchy = t_step.FusedForms(n=1, n_aux=1, coef_lens=(1,), consts=((2.0,),), make=make,
                                name="branchy")
    with pytest.raises(cg.GenerationError, match="branchy"):
        t_step.fused_step_kernel(branchy, carry, 1e-3, iters=(2, 0), compensated=False)
    assert kernels.launch_counts() == after


# ----------------------------------------------------------------------
# The generated kernel (csrc/user_family_step.cu around generated forms)
# ----------------------------------------------------------------------


def _all_ops_forms(system):
    """A family whose forms use every traced operation, ``x / c`` with a
    Python float among them (PyTorch on the card multiplies by T(1)/T(c);
    the generated code does the same)."""
    p = system.params
    cs = [t_step.concrete_scalar(p[k]) for k in ("m", "g", "k")]
    consts = None if any(c is None for c in cs) else ((cs[0], cs[1] * cs[0], cs[2]),)

    def arrays_fn(dtype, device):
        m, g, k = (p[x].to(device=device, dtype=dtype) for x in ("m", "g", "k"))
        return (torch.stack([m, g * m, k], dim=-1),)

    def make(at, fm):
        m, gm, k = (lambda: at[0](0)), (lambda: at[0](1)), (lambda: at[0](2))

        def aux(q):
            return (fm.sin(q[0]), fm.cos(q[0]), fm.exp(q[1] / 3.0),
                    fm.sqrt(abs(q[1]) + 1.0))

        def k_at(a, q):
            s, c, _, _ = a

            def at_(i, j):
                if (i, j) == (0, 0):
                    return m() * (2.0 + c * c)
                if (i, j) == (1, 1):
                    return fm.full(m() * 1.5 + k() / 7.0, s)
                return 0.25 / (2.0 + c) * s

            return at_

        def dhdq(a, q, w):
            s, _, e, r = a
            return [gm() * s - (q[0] / 7.0) * (k() * m()) + -(w[1] * w[0]) / 3.0,
                    (q[1] - 1.0) * k() / 2.0 + e * r / (1.0 + w[0] * w[0]) - fm.zero(s)]

        return t_step.FamilyFns(aux, k_at, dhdq)

    return t_step.FusedForms(n=2, n_aux=4, coef_lens=(3,), consts=consts, make=make,
                             name="all_ops", arrays_fn=arrays_fn)


#: name → (system factory on a device and dtype, q centre)
GENERATED = {
    "elastic_pendulum": (lambda dev, dtype: elastic_pendulum.make_system(device=dev,
                                                                        dtype=dtype),
                         [0.3, 1.1]),
    "bezier3": (lambda dev, dtype: tp.bezier([(-1.0, -1.0), (0.0, 1.0), (1.0, -1.0)],
                                             device=dev, dtype=dtype).system, [0.5]),
    "all_ops": (lambda dev, dtype: tp.mk_system(
        torch.ones(2), lambda q, p: q, lambda q, p: 0.5 * (q * q).sum(), device=dev,
        dtype=dtype, n=2, name="all_ops", params={"m": 1.3, "g": 9.8, "k": 30.0},
        fused_forms=_all_ops_forms), [0.2, 1.1]),
}


def _generated_modes(name, card, dtype, batch, rng):
    system = GENERATED[name][0](card, dtype)
    return {
        "const": system,
        "shared": system.replace_params(
            {k: v.clone().requires_grad_(True) for k, v in system.params.items()}),
        "member": system.replace_params({
            k: v.expand(batch, *v.shape) * torch.as_tensor(
                1.0 + 0.01 * rng.standard_normal((batch,) + (1,) * v.ndim), device=card,
                dtype=dtype)
            for k, v in system.params.items()}),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(GENERATED))
def test_generated_kernel_matches_plain_version_bitwise(card, name, dtype):
    """The generated kernel against its plain version on the same card
    tensors, bit for bit: 300 members (a ragged batch), five steps a
    launch, compensated or not, the float64 constant table, a run-time
    shared table and a per-member one, plain Verlet and Suzuki's
    composition; one launch each."""
    rng = np.random.default_rng(9)
    centre = np.asarray(GENERATED[name][1])
    for mode, system in _generated_modes(name, card, dtype, 300, rng).items():
        forms = system.fused_forms(system)
        assert t_step._kernel_key(forms) not in t_step.KERNEL_INSTANTIATIONS
        for comp in (False, True):
            for composition in ((1.0,), t_step.SUZUKI4_COMPOSITION):
                n = forms.n
                q = centre + 0.01 * rng.standard_normal((300, n))
                p = 0.05 * rng.standard_normal((300, n))
                st = t_step.fused_stepper(forms, iters=(2, 1), compensated=comp,
                                          composition=composition)
                carry = st.init(tp.phase_from_numpy(q, p, device=card, dtype=dtype))
                state, table = carry if forms.consts is None else (carry, None)
                state = state.detach()
                table = None if table is None else table.detach()
                kw = dict(iters=(2, 1), compensated=comp, steps_per_call=5,
                          composition=composition, coef=table)
                before = kernels.user_family_launch.launches
                got = t_step.fused_step_kernel(forms, state, 1e-3, **kw)
                assert kernels.user_family_launch.launches == before + 1
                want = t_step.fused_step_reference(forms, state, 1e-3, **kw)
                assert bool(torch.isfinite(got).all())
                assert torch.equal(got, want), (mode, comp, len(composition))


def test_generated_kernel_matches_library_leapfrog(card):
    """The elastic pendulum, float64 (3,2), 1024 members, two steps: the
    generated kernel and the library leapfrog within 1e-11 (the example's
    parity bound)."""
    system = elastic_pendulum.make_system(spring_k=29.4, device=card, dtype=torch.float64)
    rng = np.random.default_rng(0)
    q = np.stack([0.3 + 0.02 * rng.standard_normal(1024),
                  1.0 + 0.1 * rng.standard_normal(1024)], axis=-1)
    ph = tp.phase_from_numpy(q, 0.05 * rng.standard_normal((1024, 2)), device=card,
                             dtype=torch.float64)
    lib = tp.make_stepper(system, "leapfrog", iters=(3, 2))
    fus = tp.make_stepper(system, "leapfrog_fused", iters=(3, 2))
    dt = torch.tensor(1e-3, dtype=torch.float64)
    cl, cf = lib.init(ph), fus.init(ph)
    for _ in range(2):
        cl, cf = lib.step(cl, dt), fus.step(cf, dt)
    a, b = lib.extract(cl), fus.extract(cf)
    assert float((a.q - b.q).abs().max()) < 1e-11
    assert float((a.p - b.p).abs().max()) < 1e-11


def test_generated_parameter_change_builds_nothing(card):
    """Other parameter values reuse the library and launch it: one key, and
    no nvcc run after the first."""
    keys = set()
    for k in (12.0, 29.4, 55.0):
        system = elastic_pendulum.make_system(spring_k=k, mass=0.7, device=card,
                                              dtype=torch.float32)
        forms = system.fused_forms(system)
        key, _ = kernels.build_user_family(cg.generated(forms).header)
        keys.add(key)
        runs = kernels.NVCC_RUNS["count"]
        state = t_step.fused_stepper(forms, iters=(2, 1)).init(
            tp.Phase(torch.tensor([[0.3, 1.1]] * 8, device=card),
                     torch.zeros(8, 2, device=card)))
        got = t_step.fused_step_kernel(forms, state, 1e-3, iters=(2, 1), compensated=False)
        assert kernels.NVCC_RUNS["count"] == runs
        assert torch.equal(got, t_step.fused_step_reference(forms, state, 1e-3, iters=(2, 1),
                                                            compensated=False))
    assert len(keys) == 1


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


@pytest.mark.parametrize("entry", bs.ENTRIES, ids=[e.name for e in bs.ENTRIES])
def test_k2_backward_launches_its_kernel(card, entry):
    """Each entry's gradient at n = 20 on the card: the solves' backwards
    launch their kernel once more (gb = K⁻¹g), the factors' pull back
    through the plain masked Cholesky; all agree with the CPU's."""
    k, js, b = _k2_inputs(card, 300, 20, torch.float64, seed=2)
    args = [a.detach().requires_grad_(True) for a in _k2_args(entry, k, js, b)]
    g = torch.randn(entry.entry(*args).shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3)).to(card)
    out = entry.entry(*args)
    before = entry.launch.launches
    got = torch.autograd.grad(out, args, g)
    assert entry.launch.launches == before + (1 if entry.solves else 0)
    cpu = [a.detach().cpu().requires_grad_(True) for a in args]
    want = torch.autograd.grad(entry.entry(*cpu), cpu, g.cpu())
    for x, y in zip(got, want):
        assert float((x.cpu() - y).abs().max()) <= 1e-12 * max(1.0, float(y.abs().max()))


# ----------------------------------------------------------------------
# The roofline probes (K3a-K3c)
# ----------------------------------------------------------------------


@pytest.mark.parametrize("chains", [4, 16, 32])
def test_fma_probe_matches_plain_version(card, chains):
    """A single-rounding FMA each rep in both: bit for bit."""
    x = 1.0 + torch.rand(32 * 1024, device=card)
    before = kernels.fma_probe_launch.launches
    got = rl.fma_chain(x, 300, chains=chains, block=256)
    assert kernels.fma_probe_launch.launches == before + 1
    assert torch.equal(got, rl.fma_chain_plain(x, 300))


def test_sin_probe_matches_plain_version(card):
    """libdevice sinf against PyTorch's float32 sin on the card: an ulp or
    two a rep, contracted by sin, within 1e-6 after 64 reps."""
    x = torch.rand(16 * 1024, device=card)
    got = rl.sin_chain(x, 64, chains=8)
    want = rl.sin_chain_plain(x, 64)
    assert float((got - want).abs().max()) <= 1e-6


def test_add_one_matches_plain_version(card):
    a = torch.randn(1 << 20, device=card)
    for blocks in (1, 132, 4096):
        assert torch.equal(rl.add_one(a, blocks=blocks), rl.add_one_plain(a))
