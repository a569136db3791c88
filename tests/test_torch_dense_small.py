"""K1's one-thread dense chain at n = 2 (``csrc/fused_step.cu``, the double
pendulum) and n = 4 (``csrc/chain_variants.cu`` case 4, ``fit_masses``), on
the CPU.

Each source's part is built with g++ in the chain tests' host emulation
(``test_torch_chain_solvers._host_kernel_source``, with
``HOST_ELEMENTARY``) and run through its C entry on CPU tensors:

- against the port's plain version bit for bit, the plain version's sin,
  cos and sqrt the host build's own (``host_fm``): float64 and float32,
  shared and per-member tables, the counts the callers use as the kernel's
  constants ((2,1), (3,1)) and others read at run time, plain and
  Suzuki-composed, on 37 members, some with an angle past
  ``sincos_fast``'s range (|x| >= 105615: the library's ``sincosf``);
- against the JAX package's fused kernel (``hamilton_tpu/ops/
  pallas_step.py``) in interpret mode, float64, on the same inputs made with
  numpy from a seed;
- the layout the source reports: one thread a member, 128 threads a block,
  no dynamic shared memory (the table in registers).
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hamilton_tpu import models as jmodels
from hamilton_tpu.integrators.fixed import make_stepper as j_make_stepper
from hamilton_tpu.state import Phase as JPhase

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import kernels
from hamilton_tpu_torch.convert import params_from_numpy, phase_from_numpy
from hamilton_tpu_torch.ops import fused_step as t_step

from test_torch_chain_solvers import (
    HOST_ELEMENTARY, _flags, _host_kernel_source, _layout_query, host_fm,
)

F64, F32 = torch.float64, torch.float32
#: The reference's tile of members (``hamilton_tpu/ops/pallas_step.py``).
TILE = 1024

#: The two forms: n → (source, the code of its C entry, the port's example
#: factory, the JAX package's).
FORMS = {
    2: ("fused_step", 2, lambda dtype: tp.double_pendulum(device="cpu", dtype=dtype),
        lambda: jmodels.double_pendulum()),
    4: ("chain_variants", 4, lambda dtype: tp.chain(n_links=4, device="cpu", dtype=dtype),
        lambda: jmodels.chain(n_links=4)),
}
#: (iters, compensated, composition): the callers' counts, which the kernel
#: takes as constants, and counts it reads at run time.
MODES = (((2, 1), False, (1.0,)), ((3, 1), True, (1.0,)), ((2, 0), True, (1.0,)),
         ((3, 1), False, t_step.SUZUKI4_COMPOSITION))
#: Members whose angles leave the straight-line sine-cosine's range, member
#: → its first angle (the others 0.1 apart).  The kernel takes the library's
#: functions for a whole member where one angle leaves the range, the plain
#: version value by value: on the card both are sinf and cosf
#: (``csrc/libm_check.cu``), on the host the straight-line versions and the
#: host's libm differ by ulps, so every angle of such a member is far.
FAR_MEMBERS = {3: 2.0e5, 11: -1.5e5, 30: 3.1e5}
BATCH, STEPS = 37, 3


def _source(n):
    return FORMS[n][0]


def _part(n, dtype):
    source, code = FORMS[n][:2]
    return kernels.PARTS[source][1](int(dtype == F64), code, False)


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """The host builds of both forms' parts in both dtypes, by ``(n,
    dtype)``, with ``HOST_ELEMENTARY`` appended; built at first use."""
    csrc = Path(kernels.__file__).resolve().parent.parent / "csrc"
    built = {}

    def get(n, dtype):
        if (n, dtype) not in built:
            source = _source(n)
            where = tmp_path_factory.mktemp(f"{source}_{_part(n, dtype)}")
            src = where / "src"
            src.mkdir()
            for header in csrc.glob("*.cuh"):
                (src / header.name).write_text(header.read_text())
            (src / f"{source}.cu").write_text((csrc / f"{source}.cu").read_text()
                                              + HOST_ELEMENTARY)
            lib = ctypes.CDLL(str(_host_kernel_source(source, _part(n, dtype), where,
                                                      csrc=src)))
            entry = "hamilton_fused_step" if source == "fused_step" else \
                "hamilton_chain_variant_step"
            getattr(lib, entry).argtypes = kernels._SIGNATURES[source][entry]
            built[(n, dtype)] = (lib, getattr(lib, entry))
        return built[(n, dtype)]

    return get


def _system(n, dtype, swept, rng):
    """The form's system, with per-member parameters when ``swept``."""
    system = FORMS[n][2](dtype).system
    if not swept:
        return system
    jitter = {k: v.expand(BATCH, *v.shape) * torch.as_tensor(
        1.0 + 0.02 * rng.standard_normal((BATCH,) + tuple(v.shape)), dtype=dtype)
        for k, v in system.params.items()}
    return system.replace_params({k: v.contiguous() for k, v in jitter.items()})


def _launch(entry, n, dtype, forms, state, table, dt, iters, comp, weights, steps):
    """One launch of the host build's C entry: the state after ``steps``."""
    coef = table if table is not None else t_step.coef_table(forms, "cpu", dtype)
    got = torch.full_like(state, float("nan"))
    code = FORMS[n][1]
    assert entry(int(dtype == F64), code,
                 _flags(_source(n), code, comp, table is not None, False), coef.data_ptr(),
                 state.data_ptr(), got.data_ptr(), state.shape[2], dt, iters[0], iters[1],
                 steps, len(weights), (ctypes.c_double * len(weights))(*weights), None) == 0
    return got


@pytest.mark.parametrize("swept", [False, True], ids=["shared", "per_member"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", sorted(FORMS))
def test_dense_kernel_source_equals_plain_version(host_library, n, dtype, swept,
                                                  monkeypatch):
    """The host build against the plain version run on its elementary
    functions, bit for bit, in every mode of :data:`MODES`, over three
    steps on 37 members (:data:`FAR_MEMBERS` past the straight-line
    range)."""
    lib, entry = host_library(n, dtype)
    host_fm(lib, monkeypatch)
    rng = np.random.default_rng(40 + n)
    system = _system(n, dtype, swept, rng)
    forms = system.fused_forms(system)
    assert t_step.KERNEL_INSTANTIATIONS[t_step._kernel_key(forms)] == FORMS[n][:2]
    dt = 1e-3
    for iters, comp, weights in MODES:
        q = 0.6 + 0.3 * rng.standard_normal((BATCH, n))
        p = 0.5 * rng.standard_normal((BATCH, n))
        for b, angle in FAR_MEMBERS.items():
            q[b] = angle + 0.1 * np.arange(n)
        st = t_step.fused_stepper(forms, iters=iters, compensated=comp, composition=weights)
        carry = st.init(phase_from_numpy(q, p, device="cpu", dtype=dtype))
        state, table = carry if swept else (carry, None)
        with torch.no_grad():
            want = t_step.fused_step_reference(forms, state, dt, iters=iters,
                                               compensated=comp, steps_per_call=STEPS,
                                               composition=weights, coef=table)
        got = _launch(entry, n, dtype, forms, state, table, dt, iters, comp, weights, STEPS)
        assert torch.isfinite(want).all(), (iters, weights)
        assert torch.equal(got, want), (iters, weights, float((got - want).abs().max()))


@pytest.mark.parametrize("n", sorted(FORMS))
def test_dense_kernel_source_matches_reference_kernel(host_library, n):
    """The float64 host build (the host's libm) against the JAX package's
    fused kernel in interpret mode, on one tile of members from a seed, the
    callers' counts, five steps: to 1e-13 (dt·vdot_est, the velocity
    difference it is made from), as the plain version is held to it in
    ``tests/test_torch_fused_step.py``."""
    _, entry = host_library(n, F64)
    jex = FORMS[n][3]()
    system = FORMS[n][2](F64).system.replace_params(params_from_numpy(
        {k: np.asarray(v) for k, v in jex.system.params.items()}, device="cpu", dtype=F64))
    forms = system.fused_forms(system)
    rng = np.random.default_rng(50 + n)
    q = np.asarray(jex.init_config.q) + 0.01 * rng.standard_normal((TILE, n))
    p = 0.05 * rng.standard_normal((TILE, n))
    iters, dt, steps = ((2, 1), 1e-3, 5) if n == 2 else ((3, 1), 1e-2, 5)
    jst = j_make_stepper(jex.system, "leapfrog_fused", iters=iters, steps_per_call=steps)
    with pltpu.force_tpu_interpret_mode():
        jc = jst.step(jst.init(JPhase(jnp.asarray(q), jnp.asarray(p))), jnp.asarray(dt))
        jc = [np.moveaxis(np.asarray(t), 1, 3).reshape(TILE, n) for t in jc]
    state = t_step.fused_stepper(forms, iters=iters).init(
        phase_from_numpy(q, p, device="cpu", dtype=F64))
    got = _launch(entry, n, F64, forms, state, None, dt, iters, False, (1.0,), steps)
    assert got.shape == (len(jc), n, TILE)
    for v, ref in enumerate(jc):
        scale = dt if v == len(jc) - 1 else 1.0
        np.testing.assert_allclose(scale * got[v].T.numpy(), scale * ref, rtol=0,
                                   atol=1e-13 * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("n", sorted(FORMS))
def test_dense_layout_is_one_thread_without_shared_memory(host_library, n):
    """Both dtypes, every mode: one thread a member, 128 threads a block and
    no dynamic shared memory (the table in registers, shared or per member);
    the host build's part holds the kernel (one block an SM there)."""
    source, code = FORMS[n][:2]
    out = (ctypes.c_int * 4)()
    for dtype in (F32, F64):
        query = _layout_query(host_library(n, dtype)[0], source)
        for comp in (False, True):
            for swept in (False, True):
                assert query(int(dtype == F64), code, _flags(source, code, comp, swept, False),
                             out) == 0
                assert tuple(out) == (1, 128, 0, 1), (dtype, comp, swept)
