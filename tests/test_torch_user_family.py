"""A user's own family on the fused step, and the generated kernel's code
(``hamilton_tpu_torch/ops/fused_codegen.py``), on the CPU.

* The port's elastic pendulum (``hamilton_tpu_torch/examples/
  elastic_pendulum.py``): its library system and plain fused step against
  the JAX example's (``examples/elastic_pendulum.py``, loaded by path), the
  reference's fused kernel in interpret mode, float64, 1e-12, with shared
  constants and with per-member (k, l₀, m) tables; and the example's
  ``main`` on the CPU.
* The generated programs, evaluated by :func:`interpret` here,
  equal the plain version bitwise on the CPU for every bundled family, the
  chain's forms, a 3-point Bézier, the elastic pendulum and a family using
  every traced operation, in float32 and float64 and in all three table
  modes.  ``x / c`` by a Python float is the one operation where the CPU
  and the card round differently (the card multiplies by the reciprocal):
  the CPU check interprets it as the CPU divides, and the generated code
  follows the card.
* The generated source built with g++ against a small host shim (the CUDA
  keywords stubbed, the launch a loop over one-thread blocks), two steps in
  float64 against the plain version to 1e-13 (the host's libm against
  PyTorch's sin/cos: an ulp).
* Forms with control flow on a traced value raise, naming the family and
  the form; a change of parameter values keeps the library's key.
"""

import dataclasses
import importlib.util
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hamilton_tpu.integrators.fixed import make_stepper as j_make_stepper
from hamilton_tpu.state import Phase as JPhase
from hamilton_tpu.utils import roofline as j_roofline

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import kernels
from hamilton_tpu_torch.examples import elastic_pendulum as t_example
from hamilton_tpu_torch.ops import fused_codegen as cg
from hamilton_tpu_torch.ops import fused_step as t_step
from hamilton_tpu_torch.utils import roofline as t_roofline

from test_torch_chain_solvers import HOST_ELEMENTARY, host_fm
from test_torch_roofline import _costs_agree

REPO = Path(__file__).resolve().parent.parent
F64 = torch.float64
TILE = 1024  # the reference's fused stepper takes batches of 1024·k
THREE_POINTS = [(-1.0, -1.0), (0.0, 1.0), (1.0, -1.0)]


def _load_reference_example():
    path = REPO / "examples" / "elastic_pendulum.py"
    spec = importlib.util.spec_from_file_location("elastic_pendulum_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


J_EXAMPLE = _load_reference_example()


def all_ops_forms(system):
    """A family whose forms use every traced operation: ``x / c`` and
    ``c / x`` with Python floats, ``abs``, every ``fm`` function, constants
    folded in double (``k()/7``, ``m()·1.5``) and a table-free literal."""
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


def all_ops_system(dtype=F64):
    return tp.mk_system(torch.ones(2), lambda q, p: q, lambda q, p: 0.5 * (q * q).sum(),
                        device="cpu", dtype=dtype, n=2, name="all_ops",
                        params={"m": 1.3, "g": 9.8, "k": 30.0}, fused_forms=all_ops_forms)


def sincos_recip_forms(system):
    """A family whose aux takes the sine and the cosine of one value, a
    reciprocal ``1 / x`` and a square root: the generated code's one
    ``line_sincos``, its ``line_rcp`` and its ``line_sqrt``."""
    p = system.params
    cs = [t_step.concrete_scalar(p[k]) for k in ("m", "g")]
    consts = None if any(c is None for c in cs) else ((cs[0], cs[1] * cs[0]),)

    def arrays_fn(dtype, device):
        m, g = (p[x].to(device=device, dtype=dtype) for x in ("m", "g"))
        return (torch.stack([m, g * m], dim=-1),)

    def make(at, fm):
        m, gm = (lambda: at[0](0)), (lambda: at[0](1))

        def aux(q):
            u = 1.0 + q[1] * q[1]
            return fm.sin(q[0]), fm.cos(q[0]), 1.0 / u, fm.sqrt(u)

        def k_at(a, q):
            s, c, r, _ = a

            def at_(i, j):
                if (i, j) == (0, 0):
                    return m() * (1.0 + r)
                if (i, j) == (1, 1):
                    return fm.full(m(), s)
                return m() * (0.25 * (s * c))

            return at_

        def dhdq(a, q, w):
            s, c, r, h = a
            return [gm() * s - m() * (0.25 * (c * c - s * s)) * (w[0] * w[1]),
                    q[1] * (r * h) - m() * (q[1] * (r * r)) * (w[0] * w[0])]

        return t_step.FamilyFns(aux, k_at, dhdq)

    return t_step.FusedForms(n=2, n_aux=4, coef_lens=(2,), consts=consts, make=make,
                             name="sincos_recip", arrays_fn=arrays_fn)


def sincos_recip_system(dtype=F64):
    return tp.mk_system(torch.ones(2), lambda q, p: q, lambda q, p: 0.5 * (q * q).sum(),
                        device="cpu", dtype=dtype, n=2, name="sincos_recip",
                        params={"m": 1.3, "g": 9.8}, fused_forms=sincos_recip_forms)


def _registry_system(name, dtype):
    kw = {"n_links": 4} if name == "chain" else {}
    return tp.REGISTRY[name](device="cpu", dtype=dtype, **kw).system


#: name → (system factory of a dtype, q centre)
FAMILIES = {
    **{name: (lambda dtype, name=name: _registry_system(name, dtype),
              None) for name in sorted(tp.REGISTRY)},
    **{f"chain3-{solver}": (lambda dtype, solver=solver: tp.chain(
        n_links=3, fused_solver=solver, device="cpu", dtype=dtype).system, [0.4, 0.5, 0.6])
       for solver in ("semiseparable", "mobius", "linv")},
    "bezier3": (lambda dtype: tp.bezier(THREE_POINTS, device="cpu", dtype=dtype).system,
                [0.5]),
    "elastic_pendulum": (lambda dtype: t_example.make_system(device="cpu", dtype=dtype),
                         [0.3, 1.1]),
    "all_ops": (all_ops_system, [0.2, 1.1]),
    "sincos_recip": (sincos_recip_system, [0.4, 0.7]),
}


def _centre(name, system):
    qc = FAMILIES[name][1]
    if qc is None:
        kw = {"n_links": 4} if name == "chain" else {}
        ex = tp.REGISTRY[name](device="cpu", dtype=F64, **kw)
        qc = ex.init_config.q.tolist()
    return np.asarray(qc, np.float64)


def _modes(system, batch, rng):
    """The system with constant shared params, with params that need a
    gradient (a run-time shared table) and with per-member params."""
    modes = {"const": system}
    if system.params is not None:
        modes["shared"] = system.replace_params(
            {k: v.clone().requires_grad_(True) for k, v in system.params.items()})
        modes["member"] = system.replace_params({
            k: (v.expand(batch, *v.shape) * torch.as_tensor(
                1.0 + 0.01 * rng.standard_normal((batch,) + (1,) * v.ndim), dtype=v.dtype)
                ).contiguous()
            for k, v in system.params.items()})
    return modes


def _initial(system, centre, batch, dtype, rng, kw):
    forms = system.fused_forms(system)
    n = forms.n
    q = torch.as_tensor(centre + 0.01 * rng.standard_normal((batch, n)), dtype=dtype)
    p = torch.as_tensor(0.05 * rng.standard_normal((batch, n)), dtype=dtype)
    st = t_step.fused_stepper(forms, **kw)
    carry = st.init(tp.Phase(q, p))
    state, table = carry if forms.consts is None else (carry, None)
    return forms, state.detach(), None if table is None else table.detach()


# ----------------------------------------------------------------------
# The recorded programs, evaluated with PyTorch
# ----------------------------------------------------------------------


def interpret(program, inputs, table, *, card):
    """Evaluate a recorded program with PyTorch on the plain version's
    values: ``inputs`` maps each input group to its member values,
    ``table(k)`` gives flat table entry k (a Python float of the constant
    table, or a tensor).  T values are tensors of the inputs' dtype, doubles
    Python floats.  ``card`` reads ``x / c`` as PyTorch's CUDA division by
    a scalar (a product with the reciprocal), else as its CPU division."""
    like = next(x for group in inputs.values() for x in group if torch.is_tensor(x))

    def t_of(x):
        return torch.tensor(x, dtype=like.dtype, device=like.device)

    vals = []
    for _, op, args in program.ops:
        if op == "in":
            v = inputs[args[0]][args[1]]
        elif op == "tab":
            v = table(args[0])
        elif op == "lit":
            v = float(args[0])
        elif op == "zero":
            v = torch.zeros_like(like)
        elif op == "cvt":
            v = t_of(vals[args[0]])
        elif op == "neg":
            v = -vals[args[0]]
        elif op == "abs":
            v = abs(vals[args[0]])
        elif op in ("sin", "cos", "exp", "sqrt"):
            v = getattr(torch, op)(vals[args[0]])
        elif op == "divs":
            a, c = vals[args[0]], t_of(vals[args[1]])
            v = a * (t_of(1.0) / c) if card else a / c
        else:
            a, b = vals[args[0]], vals[args[1]]
            v = {"add": a + b, "sub": a - b, "mul": a * b}[op] if op != "div" else a / b
        vals.append(v)
    return [vals[o] for o in program.outputs]


def interpreted_forms(forms, *, card=False):
    """``forms`` with its ``make`` replaced by the interpretation of its
    generated programs: the plain step runs the recording, to be held
    against the plain step of the forms themselves."""
    gen = cg.generated(forms)
    lengths = tuple(forms.coef_lens)
    where = [(t, i) for t in range(len(lengths)) for i in range(lengths[t])]

    def make(at, fm):
        progs = gen.const if forms.consts is not None else gen.runtime

        def run(form, **inputs):
            return interpret(progs[form], inputs, lambda k: at[where[k][0]](where[k][1]),
                             card=card)

        def k_at(a, q):
            flat = dict(zip(cg._lower(forms.n), run("kmat", a=a, q=q)))
            return lambda i, j: flat[(i, j)]

        factor_solve = None
        if "factor" in progs:
            factor_solve = (lambda a, q: tuple(run("factor", a=a, q=q)),
                            lambda f, b: run("solve", f=f, b=b))
        shift = None
        if "aux_shift" in progs:
            shift = lambda a, dq: tuple(run("aux_shift", a=a, dq=dq))  # noqa: E731
        return t_step.FamilyFns(lambda q: tuple(run("aux", q=q)),
                                k_at if "kmat" in progs else None,
                                lambda a, q, w: run("dhdq", a=a, q=q, w=w),
                                None, factor_solve, shift)

    return dataclasses.replace(forms, make=make)


# ----------------------------------------------------------------------
# The elastic pendulum against the JAX example
# ----------------------------------------------------------------------


def _params_np(rng, b):
    return {"mass": 0.5 + rng.random(b), "gravity": np.full(b, 9.8),
            "spring_k": 15.0 + 30.0 * rng.random(b), "rest_length": 0.8 + 0.4 * rng.random(b)}


@pytest.mark.parametrize("tables", ["shared", "per_member"])
def test_plain_step_matches_the_reference_kernel(tables):
    """One step of the port's plain fused step (3,2) against the JAX
    example's fused kernel in interpret mode (``tests/test_examples.py``'s
    parity test), float64, 1024 members, to 1e-12: shared constants, or
    per-member (m, k, l₀) tables."""
    rng = np.random.default_rng(7)
    jsys = J_EXAMPLE.make_system()
    tsys = t_example.make_system(device="cpu", dtype=F64)
    if tables == "per_member":
        params = _params_np(rng, TILE)
        jsys = jsys.replace_params({k: jnp.asarray(v) for k, v in params.items()})
        tsys = tsys.replace_params(tp.params_from_numpy(params, device="cpu", dtype=F64))
    q = np.stack([0.3 + 0.02 * rng.standard_normal(TILE),
                  1.0 + 0.1 * rng.standard_normal(TILE)], axis=-1)
    p = 0.05 * rng.standard_normal((TILE, 2))
    jfus = j_make_stepper(jsys, "leapfrog_fused", iters=(3, 2))
    with pltpu.force_tpu_interpret_mode():
        jout = jfus.extract(jfus.step(jfus.init(JPhase(jnp.asarray(q), jnp.asarray(p))),
                                      jnp.float64(1e-3)))
        jq, jp = np.asarray(jout.q), np.asarray(jout.p)
    tfus = tp.make_stepper(tsys, "leapfrog_fused", iters=(3, 2))
    tout = tfus.extract(tfus.step(tfus.init(tp.phase_from_numpy(q, p, device="cpu",
                                                                dtype=F64)),
                                  torch.tensor(1e-3, dtype=F64)))
    np.testing.assert_allclose(tout.q.numpy(), jq, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tout.p.numpy(), jp, rtol=0, atol=1e-12)


def test_library_system_matches_the_reference():
    """The library definitions agree: H and ∂H/∂q on random states and
    per-member params, float64, 1e-12."""
    from hamilton_tpu import mechanics as jmech

    rng = np.random.default_rng(3)
    b = 64
    params = _params_np(rng, b)
    jsys = J_EXAMPLE.make_system().replace_params({k: jnp.asarray(v) for k, v in params.items()})
    tsys = t_example.make_system(device="cpu", dtype=F64).replace_params(
        tp.params_from_numpy(params, device="cpu", dtype=F64))
    q = np.stack([0.3 * rng.standard_normal(b), 1.0 + 0.1 * rng.standard_normal(b)], axis=-1)
    p = rng.standard_normal((b, 2))
    jh = jmech.hamiltonian(jsys, JPhase(jnp.asarray(q), jnp.asarray(p)))
    th = tp.hamiltonian(tsys, tp.phase_from_numpy(q, p, device="cpu", dtype=F64))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-12)
    jdq, _ = jmech.ham_eqs(jsys, JPhase(jnp.asarray(q), jnp.asarray(p)))
    tdq, _ = tp.ham_eqs(tsys, tp.phase_from_numpy(q, p, device="cpu", dtype=F64))
    np.testing.assert_allclose(tdq.numpy(), np.asarray(jdq), rtol=0, atol=1e-12)


def test_example_main_on_the_cpu():
    """The port's example on the CPU: the parity stage (float64, 1e-11) and
    the fused float32 (2,1) sweep of 24 spring constants over 6000 steps,
    whose swing peaks within 25 % of k_res = 3mg/l₀."""
    results = {}
    assert t_example.main(["--device", "cpu", "--fused", "--sweep", "24", "--steps", "6000"],
                          results=results) == 0
    assert results["parity_err"] < 1e-11
    assert abs(results["peak_k_over_k_res"] - 1.0) < 0.25
    assert results["launches"] == {}  # the CPU runs the plain version


def test_fused_step_cost_counts_a_generated_family():
    """``fused_step_cost`` runs the user's forms as it runs a bundled
    family's: its counts equal the reference's jaxpr walk of the JAX
    example (float32, (2,1), one step a call, shared and per-member)."""
    rng = np.random.default_rng(5)
    for per_member in (False, True):
        jsys = J_EXAMPLE.make_system()
        tsys = t_example.make_system(device="cpu", dtype=torch.float32)
        if per_member:
            params = _params_np(rng, TILE)
            jsys = jsys.replace_params({k: jnp.asarray(v) for k, v in params.items()})
            tsys = tsys.replace_params(tp.params_from_numpy(params, device="cpu",
                                                            dtype=torch.float32))
        jsys = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jsys)
        j_cost = j_roofline.fused_step_cost(jsys, iters=(2, 1), steps_per_call=1,
                                            compensated=False, batch=TILE)
        t_cost = t_roofline.fused_step_cost(tsys, iters=(2, 1), steps_per_call=1,
                                            compensated=False, batch=TILE)
        _costs_agree(j_cost, t_cost)
        assert t_cost["unknown_ops_per_member_step"] == 0


# ----------------------------------------------------------------------
# The generated programs against the plain version
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_generated_program_equals_the_plain_version(name, dtype):
    """Three steps a call, (2,0) Kahan and (3,1) Suzuki-composed, in every
    table mode: the plain version running the interpreted programs equals
    the plain version of the forms bit for bit (``x / c`` read as the CPU
    divides: :func:`interpret` with ``card=False``)."""
    rng = np.random.default_rng(11)
    system = FAMILIES[name][0](dtype)
    if system.fused_forms is None:
        pytest.skip(f"{name} has no fused forms")
    centre = _centre(name, system)
    for mode, sysm in _modes(system, 16, rng).items():
        forms = sysm.fused_forms(sysm)
        interpreted = interpreted_forms(forms, card=False)
        for kw in (dict(iters=(2, 0), compensated=True),
                   dict(iters=(3, 1), compensated=False,
                        composition=t_step.SUZUKI4_COMPOSITION)):
            forms_, state, table = _initial(sysm, centre, 16, dtype, rng, kw)
            run = dict(kw, steps_per_call=3, coef=table)
            with torch.no_grad():
                want = t_step.fused_step_reference(forms_, state, 1e-3, **run)
                got = t_step.fused_step_reference(interpreted, state, 1e-3, **run)
            assert torch.equal(got, want), (mode, kw)


def test_division_by_a_constant_follows_the_card():
    """``x / c`` is recorded as its own operation; the card's reading (a
    product with T(1)/T(c)) and the CPU's (a division) differ by an ulp
    where they differ, and only there; ``c / x`` is ``(1/x)·c`` on both."""
    system = all_ops_system(torch.float32)
    gen = cg.generated(system.fused_forms(system))
    assert any(op == "divs" for _, op, _ in gen.runtime["dhdq"].ops)
    assert "* (T(1) / static_cast<T>(" in gen.header
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(4096), dtype=torch.float32)
    program = cg.Program("t", [("T", "in", ("x", 0)), ("D", "lit", (7.0,)),
                               ("T", "divs", (0, 1))], [2])
    card = interpret(program, {"x": [x]}, None, card=True)[0]
    cpu = interpret(program, {"x": [x]}, None, card=False)[0]
    assert torch.equal(cpu, x / 7.0)
    assert torch.equal(card, x * (torch.tensor(1.0) / torch.tensor(7.0)))
    assert float(((card - cpu) / cpu).abs().max()) <= 2 ** -23


def test_constants_fold_in_double():
    """With constant shared parameters, ``kspr()·l0()`` folds in double and
    rounds to T once (the plain version's Python floats); with a run-time
    table it is a product in T."""
    system = t_example.make_system(device="cpu", dtype=torch.float32)
    gen = cg.generated(system.fused_forms(system))
    const_ops = gen.const["dhdq"].ops
    assert ("D", "mul", (const_ops.index(("D", "tab", (2,))),
                         const_ops.index(("D", "tab", (3,))))) in const_ops
    run_ops = gen.runtime["dhdq"].ops
    assert ("T", "mul", (run_ops.index(("T", "tab", (2,))),
                         run_ops.index(("T", "tab", (3,))))) in run_ops
    assert "const double" in gen.header and "cf[" in gen.header


# ----------------------------------------------------------------------
# What cannot be generated, and what keys a build
# ----------------------------------------------------------------------


def _user_forms(dhdq_body, name="user_branch"):
    def make(at, fm):
        def aux(q):
            return (fm.sin(q[0]),)

        def k_at(a, q):
            return lambda i, j: fm.full(at[0](0), a[0])

        return t_step.FamilyFns(aux, k_at, lambda a, q, w: dhdq_body(at, fm, a, q, w))

    return t_step.FusedForms(n=1, n_aux=1, coef_lens=(1,), consts=((2.0,),), make=make,
                             name=name, arrays_fn=lambda dtype, device: (
                                 torch.tensor([2.0], dtype=dtype, device=device),))


@pytest.mark.parametrize("body", [
    lambda at, fm, a, q, w: [q[0] if at[0](0) > 0 else -q[0]],
    lambda at, fm, a, q, w: [q[0] * (1.0 if bool(q[0]) else 2.0)],
    lambda at, fm, a, q, w: [q[0] * float(at[0](0))],
    lambda at, fm, a, q, w: [q[0] * math.sin(at[0](0))],
    lambda at, fm, a, q, w: [q[0] ** 2],
    lambda at, fm, a, q, w: [fm.sin(at[0](0)) * q[0]],
], ids=["compare", "bool", "float", "math", "pow", "fm-of-constant"])
def test_control_flow_on_a_traced_value_raises(body):
    """A branch on a traced value, a traced value read as a Python number, or
    an operation outside the traced set raises GenerationError naming the
    family and the form — in the check a launch makes, without a card.  An
    ``fm`` function of a table entry is a member value's operation with a
    run-time table, and fails only on the constant table, as the plain
    version's ``torch.sin`` of a Python float fails."""
    forms = _user_forms(body)
    with pytest.raises(cg.GenerationError, match="user_branch"):
        t_step.check_kernel_args("cuda", torch.float64, forms, (4, 1, 8))
    try:
        gen = cg.generate(forms)
    except cg.GenerationError as exc:
        assert "family 'user_branch', form dhdq" in str(exc)
    else:
        assert gen.const is None and "form dhdq: fm.sin of a constant" in gen.const_error
        assert "kAvailable = false" in gen.header


def test_a_constant_carried_between_forms_raises():
    """An aux entry that is a Python float of the constant table (the plain
    version would carry it as one) is refused on the constant table."""
    def make(at, fm):
        return t_step.FamilyFns(lambda q: (at[0](0),), lambda a, q: lambda i, j: a[0],
                                lambda a, q, w: [q[0]])

    forms = t_step.FusedForms(n=1, n_aux=1, coef_lens=(1,), consts=((2.0,),), make=make,
                              name="const_aux", arrays_fn=None)
    gen = cg.generate(forms)  # a run-time table entry is a member value
    assert gen.const is None and "form aux: entry 0 does not depend" in gen.const_error
    with pytest.raises(cg.GenerationError, match=r"form aux: entry 0 does not depend"):
        t_step.check_kernel_args("cuda", torch.float64, forms, (4, 1, 8))


def test_a_parameter_change_keeps_the_library_key():
    """Other parameter values — shared, per member, or needing a gradient —
    give the same header and so the same library; another structure (a
    literal in the forms) gives another."""
    keys = set()
    for k in (10.0, 29.4, 60.0):
        system = t_example.make_system(spring_k=k, rest_length=0.9, device="cpu",
                                        dtype=torch.float32)
        keys.add(kernels._user_family_paths(cg.generate(system.fused_forms(system)).header)[0])
    sweep = t_example.make_system(device="cpu", dtype=torch.float32).replace_params(
        tp.params_from_numpy(_params_np(np.random.default_rng(0), 32), device="cpu",
                             dtype=torch.float32))
    keys.add(kernels._user_family_paths(cg.generate(sweep.fused_forms(sweep)).header)[0])
    assert len(keys) == 1
    other = _user_forms(lambda at, fm, a, q, w: [at[0](0) * (q[0] - 1.0)])
    again = _user_forms(lambda at, fm, a, q, w: [at[0](0) * (q[0] - 2.0)])
    assert (kernels._user_family_paths(cg.generate(other).header)[0]
            != kernels._user_family_paths(cg.generate(again).header)[0])


# ----------------------------------------------------------------------
# The generated source, built with g++ in a host emulation
# ----------------------------------------------------------------------

HOST_SHIM = r"""
#pragma once
#include <cmath>
#include <cstring>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
#define __shared__ static
typedef void* cudaStream_t;
typedef int cudaError_t;
struct HostDim3 { unsigned x; };
static HostDim3 blockIdx, threadIdx, blockDim;
inline void __syncthreads() {}
template <typename T> inline T __ldg(const T* p) { return *p; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }
using std::sin; using std::cos; using std::exp; using std::sqrt; using std::fabs;
// the round-to-nearest intrinsics as the host's IEEE operations (built
// without contraction)
inline float __frcp_rn(float x) { return 1.0f / x; }
inline double __drcp_rn(double x) { return 1.0 / x; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __fsqrt_rn(float x) { return std::sqrt(x); }
inline double __dsqrt_rn(double x) { return std::sqrt(x); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline int __float2int_rn(float x) { return (int)std::nearbyint(x); }
inline float __int2float_rn(int x) { return (float)x; }
inline unsigned __float_as_uint(float x) { unsigned u; std::memcpy(&u, &x, 4); return u; }
inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
// a launch as a loop over one-thread blocks
#define HOST_LAUNCH(batch, ...) \
  for (long long hb = 0; hb < (batch); ++hb) { \
    blockIdx.x = (unsigned)hb; blockDim.x = 1; threadIdx.x = 0; __VA_ARGS__; }
"""


def _host_library(header: str, where: Path, extra: str = "") -> Path:
    """``csrc/user_family_step.cu`` around ``header`` as a host library,
    with ``extra`` appended to the source."""
    csrc = REPO / "hamilton_tpu_torch" / "csrc"
    where.mkdir(parents=True, exist_ok=True)
    (where / "cuda_runtime.h").write_text(HOST_SHIM)
    (where / "user_family.h").write_text(header)
    for h in csrc.glob("*.cuh"):
        (where / h.name).write_text(h.read_text())
    src, n = re.subn(r"(\w+<[^<>;]*>)\s*<<<.*?>>>\((.*?)\);",
                     lambda m: f"HOST_LAUNCH(a.batch, {m.group(1)}({m.group(2)}));",
                     (csrc / "user_family_step.cu").read_text(), flags=re.S)
    assert n == 1
    (where / "user_family_step.cc").write_text(src + extra)
    lib = where / "libuser_family_host.so"
    proc = subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                           "-w", "-I", str(where), "-o", str(lib),
                           str(where / "user_family_step.cc")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return lib


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the generated source")


@pytest.mark.parametrize("name", ["elastic_pendulum", "bezier3", "chain3-semiseparable",
                                  "all_ops", "room", "sincos_recip"])
def test_generated_source_built_on_the_host(gxx, name, tmp_path):
    """The generated header in ``csrc/user_family_step.cu``, compiled by g++
    in the host emulation and run through its C entry on CPU tensors:
    float64, every table mode (room: no table, a null pointer), plain (2,0)
    Kahan and Suzuki-composed (3,1),
    two steps against the plain version to 1e-13 (vdot_est as dt·vdot_est,
    the velocity difference it is made from)."""
    import ctypes

    rng = np.random.default_rng(2)
    system = FAMILIES[name][0](F64)
    centre = _centre(name, system)
    libs = {}
    for mode, sysm in _modes(system, 8, rng).items():
        forms = sysm.fused_forms(sysm)
        header = cg.generate(forms).header
        if header not in libs:
            libs[header] = ctypes.CDLL(str(_host_library(header, tmp_path / f"b{len(libs)}")))
        entry = libs[header].hamilton_user_family_step
        entry.argtypes = kernels._SIGNATURES["family_step"]["hamilton_family_step"]
        for kw in (dict(iters=(2, 0), compensated=True, composition=(1.0,)),
                   dict(iters=(3, 1), compensated=False,
                        composition=t_step.SUZUKI4_COMPOSITION)):
            forms_, state, table = _initial(sysm, centre, 8, F64, rng, kw)
            with torch.no_grad():
                want = t_step.fused_step_reference(forms_, state, 1e-3, steps_per_call=2,
                                                   coef=table, **kw)
            if forms_.consts is not None:
                coef = torch.tensor([v for t in forms_.consts for v in t], dtype=F64)
            else:
                coef = table
            got = torch.empty_like(state)
            w = kw["composition"]
            flags = int(kw["compensated"]) << 1 | int(coef.ndim == 2) << 2
            code = entry(1, 0 if forms_.consts is not None else 1, flags,
                         coef.data_ptr() if coef.numel() else None, state.data_ptr(),
                         got.data_ptr(), state.shape[2], 1e-3, kw["iters"][0], kw["iters"][1],
                         2, len(w), (ctypes.c_double * len(w))(*w), None)
            assert code == 0
            scale = torch.ones(state.shape[0], 1, 1, dtype=F64)
            scale[-1] = 1e-3
            assert float(((got - want) * scale).abs().max()) <= 1e-13, (mode, kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["sincos_recip", "elastic_pendulum", "bezier3"])
def test_generated_source_equals_plain_on_the_host(gxx, name, dtype, tmp_path, monkeypatch):
    """The generated header in ``csrc/user_family_step.cu``, built with g++
    in the host emulation, equal bit for bit to the plain version run on the
    host build's elementary functions (``host_fm``: the sine and cosine of
    a value, ``exp`` and the square root; the reciprocals are the IEEE division
    on both sides): float32 and float64, every table mode, (2,0) Kahan and
    Suzuki-composed (3,1), three steps, 12 members, one with an angle beyond
    ``sincos_fast``'s range (sincos_recip) or beyond a wall, where ``exp``
    overflows (bezier3)."""
    import ctypes

    rng = np.random.default_rng(5)
    system = FAMILIES[name][0](dtype)
    centre = _centre(name, system)
    edge = {"sincos_recip": (2.0e5, 0.7), "bezier3": (-20.0,)}.get(name)
    libs = {}
    for mode, sysm in _modes(system, 12, rng).items():
        header = cg.generate(sysm.fused_forms(sysm)).header
        if header not in libs:
            libs[header] = ctypes.CDLL(str(_host_library(header, tmp_path / f"b{len(libs)}",
                                                         HOST_ELEMENTARY)))
        lib = libs[header]
        host_fm(lib, monkeypatch)
        entry = lib.hamilton_user_family_step
        entry.argtypes = kernels._SIGNATURES["family_step"]["hamilton_family_step"]
        for kw in (dict(iters=(2, 0), compensated=True, composition=(1.0,)),
                   dict(iters=(3, 1), compensated=False,
                        composition=t_step.SUZUKI4_COMPOSITION)):
            forms = sysm.fused_forms(sysm)
            q = torch.as_tensor(centre + 0.01 * rng.standard_normal((12, forms.n)), dtype=dtype)
            if edge is not None:
                q[5] = torch.as_tensor(edge, dtype=dtype)
            p = torch.as_tensor(0.05 * rng.standard_normal((12, forms.n)), dtype=dtype)
            carry = t_step.fused_stepper(forms, **kw).init(tp.Phase(q, p))
            state, table = carry if forms.consts is None else (carry, None)
            with torch.no_grad():
                want = t_step.fused_step_reference(forms, state, 1e-3, steps_per_call=3,
                                                   coef=table, **kw)
            if forms.consts is not None:
                coef = torch.tensor([v for t in forms.consts for v in t], dtype=F64)
            else:
                coef = table
            got = torch.full_like(state, float("nan"))
            w = kw["composition"]
            flags = int(kw["compensated"]) << 1 | int(coef.ndim == 2) << 2
            code = entry(int(dtype == F64), 0 if forms.consts is not None else 1, flags,
                         coef.data_ptr() if coef.numel() else None, state.data_ptr(),
                         got.data_ptr(), 12, 1e-3, kw["iters"][0], kw["iters"][1], 3, len(w),
                         (ctypes.c_double * len(w))(*w), None)
            assert code == 0
            assert torch.isfinite(want).all(), (mode, kw)
            assert torch.equal(got, want), (mode, kw, float((got - want).abs().max()))


#: The chains' generated kernels: the reference's stress chain's
#: semiseparable form (n = 40, (2,0)) and its default chain (dense, n = 20,
#: (2,1) as the bench's ``anchor21``), both since routed to hand-written
#: kernels (``csrc/semisep_wide.cu``, the dense lane kernel), which
#: ``scripts/k1_route_ab.py`` times against them: (solver, n, iters).
GENERATED_CHAINS = {"dense20": ("dense", 20, (2, 1)),
                    "semiseparable40": ("semiseparable", 40, (2, 0))}


@pytest.fixture(scope="module", params=sorted(GENERATED_CHAINS))
def generated_chain_host(request, tmp_path_factory):
    """A generated chain's source, built once with g++ in the host emulation
    with ``HOST_ELEMENTARY``: ``(case, library)``."""
    import ctypes

    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the generated source")
    solver, n, _ = GENERATED_CHAINS[request.param]
    system = tp.chain(n_links=n, fused_solver=solver, device="cpu", dtype=F64).system
    forms = system.fused_forms(system)
    assert t_step._kernel_key(forms) in t_step.KERNEL_INSTANTIATIONS
    where = tmp_path_factory.mktemp(request.param)
    return request.param, ctypes.CDLL(str(_host_library(cg.generate(forms).header, where,
                                                        HOST_ELEMENTARY)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_generated_chain_equals_plain_on_the_host(generated_chain_host, dtype, monkeypatch):
    """The chain's generated kernel run through its C entry, equal bit for
    bit to the plain version on the host build's elementary functions:
    Kahan, the float64 constant table, one step, 37 members."""
    import ctypes

    case, lib = generated_chain_host
    solver, n, iters = GENERATED_CHAINS[case]
    host_fm(lib, monkeypatch)
    entry = lib.hamilton_user_family_step
    entry.argtypes = kernels._SIGNATURES["family_step"]["hamilton_family_step"]
    ex = tp.chain(n_links=n, fused_solver=solver, device="cpu", dtype=dtype)
    forms = ex.system.fused_forms(ex.system)
    rng = np.random.default_rng(9)
    q = ex.init_config.q + torch.as_tensor(0.01 * rng.standard_normal((37, n)), dtype=dtype)
    p = torch.as_tensor(0.05 * rng.standard_normal((37, n)), dtype=dtype)
    kw = dict(iters=iters, compensated=True)
    state = t_step.fused_stepper(forms, **kw).init(tp.Phase(q, p))
    with torch.no_grad():
        want = t_step.fused_step_reference(forms, state, 1e-3, **kw)
    coef = torch.tensor([v for t in forms.consts for v in t], dtype=F64)
    got = torch.full_like(state, float("nan"))
    code = entry(int(dtype == F64), 0, 1 << 1, coef.data_ptr(), state.data_ptr(),
                 got.data_ptr(), 37, 1e-3, iters[0], iters[1], 1, 1,
                 (ctypes.c_double * 1)(1.0), None)
    assert code == 0
    assert torch.equal(got, want), float((got - want).abs().max())
