"""The chain's Möbius and L⁻¹ fused forms (``serial_chain_forms_mobius``,
``serial_chain_forms_linv`` in ``hamilton_tpu_torch/ops/fused_step.py``)
against the JAX package's, on the CPU.

The mirror of ``tests/test_pallas_step.py``'s ``TestLinvSolver`` and
``TestMobiusSolver``: the closed forms entry by entry against the
reference's forms run on numpy columns, the 5n Möbius table, the port's
plain fused step against the reference's fused kernel in interpret mode
(n = 5, float64, 1e-13), and both against the semiseparable form and the
library leapfrog, whose fixed points they share.
"""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hamilton_tpu import models as jmodels
from hamilton_tpu.integrators.fixed import make_stepper as j_make_stepper
from hamilton_tpu.ops import pallas_step as j_step
from hamilton_tpu.state import Phase as JPhase

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import kernels
from hamilton_tpu_torch.convert import params_from_numpy, phase_from_numpy
from hamilton_tpu_torch.ops import fused_step as t_step

F64 = torch.float64
TILE = 1024
SOLVERS = {
    "mobius": (j_step.serial_chain_forms_mobius, t_step.serial_chain_forms_mobius),
    "linv": (j_step.serial_chain_forms_linv, t_step.serial_chain_forms_linv),
}

#: the reference's closed forms evaluated on numpy columns
FM_NP = types.SimpleNamespace(
    sin=np.sin, cos=np.cos, exp=np.exp, sqrt=np.sqrt,
    full=lambda v, like: np.full_like(like, v), zero=np.zeros_like,
)


def _chain_params(n, seed):
    rng = np.random.default_rng(seed)
    return list(0.3 + rng.random(n)), list(0.4 + rng.random(n))


def _columns(n, b, seed):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-3, 3, (n, b))
    rhs = rng.standard_normal((n, b))
    return q, rhs


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_forms_declarations(solver):
    m, l = _chain_params(20, 0)
    jf, tf = (f(m, l, 5.0) for f in SOLVERS[solver])
    assert (tf.name, tf.n, tf.n_aux, tf.coef_lens) == (jf.name, jf.n, jf.n_aux, jf.coef_lens)
    np.testing.assert_array_equal(np.asarray(tf.consts[0]), np.asarray(jf.consts[0]))
    assert ("serial_chain_" + solver, 20, sum(tf.coef_lens)) in t_step.KERNEL_INSTANTIATIONS
    assert ("serial_chain_" + solver, 5, sum(tf.coef_lens) // 4) in t_step.KERNEL_INSTANTIATIONS


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_factor_and_solve_entries(solver):
    """n = 20: the factor's entries (Möbius: the semiseparable layout's 5n;
    L⁻¹: the n(n+1)/2 entries of L⁻¹) and the solve, against the
    reference's forms on the same numpy columns."""
    n, b = 20, 64
    m, l = _chain_params(n, 1)
    jf, tf = (f(m, l, 5.0) for f in SOLVERS[solver])
    jfam = jf.make(jf.const_accessors(), FM_NP)
    tfam = tf.make(tf.const_accessors(), t_step.FM_TORCH)
    q, rhs = _columns(n, b, 2)
    jq, tq = list(q), [torch.as_tensor(r) for r in q]
    jent = jfam.factor_solve[0](jfam.aux(jq), jq)
    tent = tfam.factor_solve[0](tfam.aux(tq), tq)
    assert len(jent) == len(tent) == (5 * n if solver == "mobius" else n * (n + 1) // 2)
    for x, y in zip(jent, tent):
        scale = max(1.0, float(np.abs(x).max()))
        np.testing.assert_allclose(y.numpy(), x, rtol=0, atol=1e-12 * scale)
    jx = jfam.factor_solve[1](jent, list(rhs))
    tx = tfam.factor_solve[1](tent, [torch.as_tensor(r) for r in rhs])
    for x, y in zip(jx, tx):
        np.testing.assert_allclose(y.numpy(), x, rtol=0, atol=1e-11)


def test_linv_solve_matches_numpy():
    """``TestLinvSolver.test_solve_matches_numpy``: the two-mat-vec solve
    against a dense numpy solve on the chain's mass matrix, n = 20."""
    n, b = 20, 64
    m, l = _chain_params(n, 11)
    fd = t_step.serial_chain_forms(m, l, 5.0)
    fl = t_step.serial_chain_forms_linv(m, l, 5.0)
    famd = fd.make(fd.const_accessors(), t_step.FM_TORCH)
    faml = fl.make(fl.const_accessors(), t_step.FM_TORCH)
    q, rhs = _columns(n, b, 12)
    tq, trhs = [torch.as_tensor(r) for r in q], [torch.as_tensor(r) for r in rhs]
    kd = famd.k_at(famd.aux(tq), tq)
    x = faml.factor_solve[1](faml.factor_solve[0](faml.aux(tq), tq), trhs)
    k_mat = np.zeros((b, n, n))
    for i in range(n):
        for j in range(n):
            k_mat[:, i, j] = np.broadcast_to(np.asarray(kd(max(i, j), min(i, j))), (b,))
    xref = np.linalg.solve(k_mat, rhs.T[..., None])[..., 0]
    np.testing.assert_allclose(torch.stack(x, -1).numpy(), xref, rtol=0, atol=1e-11)


def test_mobius_factor_matches_semiseparable():
    """``TestMobiusSolver.test_factor_matches_semiseparable``: the same
    factor in exact arithmetic, equal to float64 rounding, n = 20."""
    n, b = 20, 16
    m, l = _chain_params(n, 7)
    fon = t_step.serial_chain_forms_on(m, l, 5.0)
    fmb = t_step.serial_chain_forms_mobius(m, l, 5.0)
    fam_on = fon.make(fon.const_accessors(), t_step.FM_TORCH)
    fam_mb = fmb.make(fmb.const_accessors(), t_step.FM_TORCH)
    q, rhs = _columns(n, b, 8)
    tq, trhs = [torch.as_tensor(r) for r in q], [torch.as_tensor(r) for r in rhs]
    ent_on = fam_on.factor_solve[0](fam_on.aux(tq), tq)
    ent_mb = fam_mb.factor_solve[0](fam_mb.aux(tq), tq)
    assert len(ent_on) == len(ent_mb) == 5 * n
    for a, bb in zip(ent_on, ent_mb):
        np.testing.assert_allclose(bb.numpy(), a.numpy(), rtol=0, atol=1e-12)
    for a, bb in zip(fam_on.factor_solve[1](ent_on, trhs), fam_mb.factor_solve[1](ent_mb, trhs)):
        np.testing.assert_allclose(bb.numpy(), a.numpy(), rtol=0, atol=1e-11)


def test_mobius_table_layout():
    """``TestMobiusSolver.test_sweep_table_layout``: batched params give the
    5n table ``(l, S, g·l·S, m, 1/m)``, its 3n prefix the base family's, and
    it equals the reference's ``arrays_fn``."""
    rng = np.random.default_rng(8)
    m, l, g = 0.5 + rng.random((6, 4)), 0.5 + rng.random((6, 4)), 4.0 + rng.random(6)
    tm, tl, tg = (torch.tensor(x) for x in (m, l, g))
    fon = t_step.serial_chain_forms_on(tm, tl, tg)
    fmb = t_step.serial_chain_forms_mobius(tm, tl, tg)
    assert fmb.consts is None and fmb.coef_lens == (20,)
    (t_on,) = fon.arrays_fn(F64, "cpu")
    (t_mb,) = fmb.arrays_fn(F64, "cpu")
    assert torch.equal(t_mb[..., :12], t_on)
    assert torch.equal(t_mb[..., 12:16], tm)
    np.testing.assert_allclose(t_mb[..., 16:].numpy(), 1.0 / m, rtol=0, atol=1e-16)
    (j_mb,) = j_step.serial_chain_forms_mobius(jnp.asarray(m), jnp.asarray(l),
                                               jnp.asarray(g)).arrays_fn(jnp.float64)
    np.testing.assert_allclose(t_mb.numpy(), np.asarray(j_mb), rtol=1e-15, atol=0)


def _tiles_to_members(t):
    t = np.asarray(t)
    return np.moveaxis(t, 1, 3).reshape(t.shape[0] * TILE, t.shape[1])


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_plain_version_matches_reference_kernel(solver):
    """One spc=5 call of the (2,0) Kahan stepper on 1024 members of chain-5,
    float64: the port's plain version against the reference's fused kernel
    in interpret mode to 1e-13 (``dt·vdot_est`` as the velocity difference
    the kernel computes)."""
    jex = jmodels.chain(n_links=5, fused_solver=solver)
    tsys = tp.chain(n_links=5, fused_solver=solver, device="cpu", dtype=F64).system
    tsys = tsys.replace_params(params_from_numpy(
        {k: np.asarray(v) for k, v in jex.system.params.items()}, device="cpu", dtype=F64))
    rng = np.random.default_rng(0)
    q = np.asarray(jex.init_config.q) + 0.01 * rng.standard_normal((TILE, 5))
    p = 0.05 * rng.standard_normal((TILE, 5))
    dt = 5e-4
    jst = j_make_stepper(jex.system, "leapfrog_fused", iters=(2, 0), compensated=True,
                         steps_per_call=5)
    tst = tp.make_stepper(tsys, "leapfrog_fused", iters=(2, 0), compensated=True,
                          steps_per_call=5)
    with pltpu.force_tpu_interpret_mode():
        jc = jst.step(jst.init(JPhase(jnp.asarray(q), jnp.asarray(p))), jnp.float64(dt))
        jc = [_tiles_to_members(t) for t in jc]
    tc = tst.step(tst.init(phase_from_numpy(q, p, device="cpu", dtype=F64)), dt)
    assert tc.shape == (len(jc), 5, TILE)
    for v, ref in enumerate(jc):
        got = tc[v].T.numpy()
        if v == len(jc) - 1:
            np.testing.assert_allclose(dt * got, dt * ref, rtol=0, atol=1e-13)
        elif v == len(jc) - 2:
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-13 * max(1.0, float(np.abs(ref).max())))
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)


def _phase(n, batch, seed, dtype=F64):
    rng = np.random.default_rng(seed)
    return phase_from_numpy(0.5 + 0.01 * rng.standard_normal((batch, n)),
                            0.01 * rng.standard_normal((batch, n)), device="cpu", dtype=dtype)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_plain_version_matches_library_leapfrog(solver):
    """``TestLinvSolver.test_fused_matches_library``: converged (3,2)
    iterations, 2 steps a call carrying the factor (the L⁻¹ columns), the
    library leapfrog's fixed points to 1e-12."""
    ex = tp.chain(n_links=5, fused_solver=solver, device="cpu", dtype=F64)
    ph = _phase(5, 64, 12)
    dt = torch.tensor(1e-3, dtype=F64)
    lib = tp.make_stepper(ex.system, "leapfrog", iters=(3, 2))
    fus = tp.make_stepper(ex.system, "leapfrog_fused", iters=(3, 2), steps_per_call=2)
    c_lib, c_fus = lib.init(ph), fus.init(ph)
    for _ in range(2):
        c_lib = lib.step(lib.step(c_lib, dt), dt)
        c_fus = fus.step(c_fus, dt)
    a, b = lib.extract(c_lib), fus.extract(c_fus)
    np.testing.assert_allclose(b.q.numpy(), a.q.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.p.numpy(), a.p.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_param_sweep_matches_library(solver):
    """``TestLinvSolver.test_param_sweep_matches_library``: per-member
    (m, l, g) ride the per-member table (Möbius: its 5n) against the dense
    library leapfrog under the same params."""
    rng = np.random.default_rng(13)
    b = 64
    pb = {"masses": 0.5 + rng.random((b, 4)), "lengths": 0.5 + rng.random((b, 4)),
          "gravity": 4.0 + rng.random(b)}
    params = params_from_numpy(pb, device="cpu", dtype=F64)
    sysd = tp.chain(n_links=4, device="cpu", dtype=F64).system.replace_params(params)
    sysx = tp.chain(n_links=4, fused_solver=solver, device="cpu",
                    dtype=F64).system.replace_params(params)
    ph = _phase(4, b, 14)
    dt = torch.tensor(1e-3, dtype=F64)
    lib = tp.make_stepper(sysd, "leapfrog", iters=(3, 2))
    fus = tp.make_stepper(sysx, "leapfrog_fused", iters=(3, 2))
    state, table = fus.init(ph)
    assert table.shape == ((20 if solver == "mobius" else 12), b)
    a = lib.extract(lib.step(lib.init(ph), dt))
    c = fus.extract(fus.step((state, table), dt))
    np.testing.assert_allclose(c.q.numpy(), a.q.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(c.p.numpy(), a.p.numpy(), rtol=0, atol=1e-12)


def test_mobius_sweep_matches_semiseparable():
    """``TestMobiusSolver.test_sweep_kernel_matches_semiseparable``: chain-2
    float32 with per-member masses and gravity, one (1,1) step — the Möbius
    and semiseparable steps agree bit for bit, as the reference's do."""
    rng = np.random.default_rng(9)
    b, n = 256, 2
    ph = phase_from_numpy((0.4 + 0.01 * rng.standard_normal((b, n))).astype(np.float32),
                          (0.01 * rng.standard_normal((b, n))).astype(np.float32),
                          device="cpu", dtype=torch.float32)
    params = {"masses": (0.5 + rng.random((b, n))).astype(np.float32),
              "lengths": np.ones((b, n), np.float32),
              "gravity": (4.0 + rng.random(b)).astype(np.float32)}
    outs = {}
    for solver in ("semiseparable", "mobius"):
        sysb = tp.chain(n_links=n, fused_solver=solver, device="cpu",
                        dtype=torch.float32).system
        sysb = sysb.replace_params(params_from_numpy(params, device="cpu",
                                                     dtype=torch.float32))
        fus = tp.make_stepper(sysb, "leapfrog_fused", iters=(1, 1))
        outs[solver] = fus.extract(fus.step(fus.init(ph), 1e-3))
    assert torch.equal(outs["mobius"].q, outs["semiseparable"].q)
    assert torch.equal(outs["mobius"].p, outs["semiseparable"].p)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_against_semiseparable_over_steps(solver):
    """chain-20 float64 (2,0) Kahan over 20 steps: the other solver's plain
    fused step stays at rounding level of the semiseparable one's."""
    rng = np.random.default_rng(15)
    q = 0.5 + 0.05 * rng.standard_normal((32, 20))
    p = 0.3 * rng.standard_normal((32, 20))
    out = {}
    for s in ("semiseparable", solver):
        ex = tp.chain(n_links=20, fused_solver=s, device="cpu", dtype=F64)
        st = tp.make_stepper(ex.system, "leapfrog_fused", iters=(2, 0), compensated=True,
                             steps_per_call=20)
        out[s] = st.extract(st.step(st.init(phase_from_numpy(q, p, device="cpu", dtype=F64)),
                                    5e-4))
    np.testing.assert_allclose(out[solver].q.numpy(), out["semiseparable"].q.numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(out[solver].p.numpy(), out["semiseparable"].p.numpy(),
                               rtol=0, atol=1e-11)


def test_kernel_instantiations_accepted_and_refused():
    """The card's hand-written sizes: Möbius and L⁻¹ at n = 20 and 5, the
    dense forms at n = 4 (``fit_masses --fused``); any other n is taken by
    the kernel generated from the forms (``ops.fused_codegen``).  What is
    refused before a launch: another dtype or a state of the wrong shape."""
    for solver, n in (("mobius", 20), ("mobius", 5), ("linv", 20), ("linv", 5),
                      ("dense", 4)):
        sysx = tp.chain(n_links=n, fused_solver=solver, device="cpu", dtype=F64).system
        forms = sysx.fused_forms(sysx)
        assert t_step._kernel_key(forms) in t_step.KERNEL_INSTANTIATIONS
        t_step.check_kernel_args("cuda", torch.float32, forms, (6, n, 100))
    sys7 = tp.chain(n_links=7, fused_solver="mobius", device="cpu", dtype=F64).system
    forms7 = sys7.fused_forms(sys7)
    assert t_step._kernel_key(forms7) not in t_step.KERNEL_INSTANTIATIONS
    assert t_step.check_kernel_args("cuda", torch.float32, forms7, (6, 7, 100)) == (1.0,)
    with pytest.raises(ValueError, match="float32 or float64"):
        t_step.check_kernel_args("cuda", torch.bfloat16, forms7, (6, 7, 100))
    with pytest.raises(ValueError, match="state"):
        t_step.check_kernel_args("cuda", torch.float32, forms7, (6, 5, 100))


# ----------------------------------------------------------------------
# The L⁻¹ kernel's schedule (csrc/chain_variants.cu): G lanes a member, each
# dot a zero-padded tree split across the lanes
# ----------------------------------------------------------------------

#: the lanes a member the kernel can be built with (its layout's, checked
#: below, among them)
LINV_LANE_COUNTS = (1, 2, 4, 8, 16)


def _pow2(n):
    return 1 << (n - 1).bit_length()


def _chunk(length, lanes):
    """A lane's chunk of a dot of ``length`` terms: the dot padded to the
    power of two >= length, at least ``lanes``, split in ``lanes``."""
    return max(_pow2(length), lanes) // lanes


def _lane_tree_sum(terms, lanes):
    """The kernel's sum of a dot, in plain PyTorch: ``terms`` zero-padded to
    ``lanes`` chunks of :func:`_chunk` terms, lane g summing chunk g as a
    balanced tree, then the butterfly over the lanes (lane g adds lane g^d's
    value, d = 1, 2, ...).  Returns every lane's result."""
    c = _chunk(len(terms), lanes)
    zero = torch.zeros_like(terms[0])
    padded = list(terms) + [zero] * (c * lanes - len(terms))
    vals = []
    for g in range(lanes):
        t = padded[g * c:(g + 1) * c]
        while len(t) > 1:
            t = [t[2 * i] + t[2 * i + 1] for i in range(len(t) // 2)]
        vals.append(t[0])
    d = 1
    while d < lanes:
        vals = [vals[g] + vals[g ^ d] for g in range(lanes)]
        d *= 2
    return vals


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [20, 5])
def test_lane_split_tree_equals_tree_sum(n, dtype):
    """Every dot length 1..n and every lane count the kernel is built with:
    each lane's sum equals ``_tree_sum`` bit for bit, on terms of either
    sign spanning 1e-8..1e8."""
    rng = np.random.default_rng(40 + n)
    for length in range(1, n + 1):
        mags = 10.0 ** rng.uniform(-8, 8, (length, 512))
        terms = [torch.tensor(x, dtype=dtype)
                 for x in mags * rng.choice([-1.0, 1.0], mags.shape)]
        want = t_step._tree_sum(terms)
        for lanes in LINV_LANE_COUNTS:
            for got in _lane_tree_sum(terms, lanes):
                assert torch.equal(got, want), (length, lanes)


def _linv_schedule(n, lanes):
    """The kernel's work by lane: the L⁻¹ entries ``(i, a)`` each lane's
    columns hold (the pairs (p, n−1−p), p = g, g+G, ...), and the terms of
    each dot it multiplies: ``("y", i, a)`` of y_i = Σ L(i,a) b̃_a and
    ``("x", a, i)`` of x̃_a = Σ L(i,a) y_i, over its chunk of the dot."""
    entries, terms = [], []
    for g in range(lanes):
        cols = []
        for p in range(g, (n + 1) // 2, lanes):
            cols += [p] if n - 1 - p == p else [p, n - 1 - p]
        entries.append([(i, a) for a in cols for i in range(a, n)])
        mine = []
        for i in range(n):
            c = _chunk(i + 1, lanes)
            mine += [("y", i, g * c + k) for k in range(c) if g * c + k <= i]
        for a in range(n):
            c = _chunk(n - a, lanes)
            mine += [("x", a, a + g * c + k) for k in range(c) if g * c + k < n - a]
        terms.append(mine)
    return entries, terms


@pytest.mark.parametrize("n", [20, 5])
def test_linv_lane_schedule_covers_each_entry_and_term_once(n):
    """For every lane count the kernel is built with, the lanes' columns
    hold each entry of L⁻¹ once and the lanes' chunks take each term of the
    2n dots once; the column pairs give the lanes at most one pair's n + 1
    entries more than each other."""
    every_entry = [(i, a) for a in range(n) for i in range(a, n)]
    every_term = ([("y", i, a) for i in range(n) for a in range(i + 1)]
                  + [("x", a, i) for a in range(n) for i in range(a, n)])
    for lanes in LINV_LANE_COUNTS:
        entries, terms = _linv_schedule(n, lanes)
        assert sorted(e for lane in entries for e in lane) == sorted(every_entry)
        assert sorted(t for lane in terms for t in lane) == sorted(every_term)
        sizes = [len(lane) for lane in entries]
        assert max(sizes) - min(sizes) <= n + 1, (lanes, sizes)


#: A host emulation of the CUDA the chain-variant kernels use: a block runs
#: as blockDim threads; __syncthreads, __syncwarp and each shuffle are
#: block-wide barriers (a finished thread drops out), so the lanes of a
#: member exchange values as on the card.
HOST_SHIM = r"""
#pragma once
#include <cmath>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__ static
#define __align__(n) alignas(n)
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct HostDim3 { unsigned x; };
static HostDim3 blockIdx, blockDim;
static thread_local HostDim3 threadIdx;
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F> inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, F, int, size_t) { *blocks = 1; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }
using std::sin; using std::cos; using std::exp; using std::sqrt; using std::fabs;
template <typename T> inline T __ldg(const T* p) { return *p; }
struct HostBarrier {
  std::mutex m; std::condition_variable cv; int count = 0, waiting = 0; long gen = 0;
  void wait() {
    std::unique_lock<std::mutex> l(m);
    long g = gen;
    if (++waiting == count) { waiting = 0; ++gen; cv.notify_all(); }
    else cv.wait(l, [&] { return gen != g; });
  }
  void drop() {
    std::unique_lock<std::mutex> l(m);
    if (--count > 0 && waiting == count) { waiting = 0; ++gen; cv.notify_all(); }
  }
};
static HostBarrier host_bar;
static double host_slots[1024];
inline void __syncthreads() { host_bar.wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { host_bar.wait(); }
template <typename T> inline T __shfl_xor_sync(unsigned, T v, int d) {
  std::memcpy(&host_slots[threadIdx.x], &v, sizeof(T));
  host_bar.wait();
  T r;
  std::memcpy(&r, &host_slots[threadIdx.x ^ d], sizeof(T));
  host_bar.wait();
  return r;
}
#define HOST_LAUNCH(blocks, threads, ...) \
  for (long long hb = 0; hb < (long long)(blocks); ++hb) { \
    blockIdx.x = (unsigned)hb; blockDim.x = (unsigned)(threads); \
    host_bar.count = (int)(threads); host_bar.waiting = 0; \
    std::vector<std::thread> ths; \
    for (unsigned ht = 0; ht < (unsigned)(threads); ++ht) \
      ths.emplace_back([&, ht] { threadIdx.x = ht; __VA_ARGS__; host_bar.drop(); }); \
    for (auto& t : ths) t.join(); }
"""


def _host_chain_variants(part, where):
    """``csrc/chain_variants.cu``'s part ``part`` as a host library (the
    dynamic shared memory a static buffer, each launch a loop over blocks
    of threads)."""
    import shutil
    import subprocess

    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    csrc = Path(kernels.__file__).resolve().parent.parent / "csrc"
    (where / "cuda_runtime.h").write_text(HOST_SHIM)
    for h in csrc.glob("*.cuh"):
        (where / h.name).write_text(h.read_text())
    src, n_shared = re.subn(r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
                            r"alignas(16) static unsigned char \1[1 << 18];",
                            (csrc / "chain_variants.cu").read_text())
    src, n_launch = re.subn(r"(\w+<[^<>;]*>)\s*<<<(.*?),(.*?),.*?>>>\((.*?)\);",
                            lambda m: f"HOST_LAUNCH({m.group(2)}, {m.group(3)}, "
                                      f"{m.group(1)}({m.group(4)}));", src, flags=re.S)
    assert n_shared == 1 and n_launch == 2
    (where / "chain_variants.cc").write_text(src)
    lib = where / "libchain_variants_host.so"
    proc = subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                           "-w", "-pthread", f"-DHAMILTON_PART={part}", "-I", str(where), "-o",
                           str(lib), str(where / "chain_variants.cc")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return lib


@pytest.mark.parametrize("n", [20, 5])
def test_linv_layout_of_the_kernel_source(n, tmp_path):
    """The layout that the L⁻¹ kernel's source reports through its C entry
    (built with g++, a part that holds no kernel): lanes a member that the
    tree and schedule tests above cover, whole groups in a warp and in a
    block, shared memory within a block's 232448 bytes; no blocks an SM
    where the part holds no kernel; -1 for another case, -2 for bad flags."""
    import ctypes

    lib = ctypes.CDLL(str(_host_chain_variants(99, tmp_path)))
    query = lib.hamilton_linv_layout
    query.argtypes = kernels._SIGNATURES["chain_variants"]["hamilton_linv_layout"]
    out = (ctypes.c_int * 4)()
    code = 2 if n == 20 else 3
    for dtype_code in (0, 1):
        assert query(dtype_code, code, 2, out) == 0
        lanes, block, smem, blocks = out
        assert lanes in LINV_LANE_COUNTS and 32 % lanes == 0
        assert block % 32 == 0 and 32 <= block <= 128
        slots = n * (n + 1) // 2 + 5 * n  # at least the factor and the generators
        assert slots * (block // lanes) * (4, 8)[dtype_code] < smem <= 232448
        assert blocks == 0
    assert query(0, 0, 2, out) == -1 and query(2, code, 2, out) == -1
    assert query(0, code, 1, out) == -2


@pytest.mark.parametrize("n", [20, 5])
def test_linv_kernel_source_on_the_host(n, tmp_path):
    """The L⁻¹ kernel's source at its lanes a member, built with g++ in the
    host emulation and run through its C entry on CPU tensors: float64, a
    ragged batch (37 members), shared and per-member tables, (2,0) Kahan and
    Suzuki-composed (3,1), two steps against the plain version to 1e-13
    (vdot_est as dt·vdot_est, the velocity difference it is made from; the
    host's libm and PyTorch's sin differ by ulps)."""
    import ctypes

    lib = ctypes.CDLL(str(_host_chain_variants(2 * (2 if n == 20 else 3) + 1, tmp_path)))
    entry = lib.hamilton_chain_variant_step
    entry.argtypes = kernels._SIGNATURES["chain_variants"]["hamilton_chain_variant_step"]
    layout = (ctypes.c_int * 4)()
    lib.hamilton_linv_layout.argtypes = kernels._SIGNATURES["chain_variants"][
        "hamilton_linv_layout"]
    assert lib.hamilton_linv_layout(1, 2 if n == 20 else 3, 2, layout) == 0
    assert layout[3] == 1  # the host emulation's blocks an SM, from the part that holds it
    rng = np.random.default_rng(17)
    batch, dt = 37, 5e-4
    for swept in (False, True):
        system = tp.chain(n_links=n, fused_solver="linv", device="cpu", dtype=F64).system
        if swept:
            system = system.replace_params(params_from_numpy({
                "masses": 1.0 + 0.05 * rng.standard_normal((batch, n)),
                "lengths": 1.0 + 0.1 * rng.random((batch, n)),
                "gravity": 5.0 + 0.1 * rng.standard_normal(batch)}, device="cpu", dtype=F64))
        forms = system.fused_forms(system)
        for iters, comp, weights in (((2, 0), True, (1.0,)),
                                     ((3, 1), False, t_step.SUZUKI4_COMPOSITION)):
            st = t_step.fused_stepper(forms, iters=iters, compensated=comp, composition=weights)
            ph = phase_from_numpy(0.5 + 0.05 * rng.standard_normal((batch, n)),
                                  0.3 * rng.standard_normal((batch, n)), device="cpu",
                                  dtype=F64)
            carry = st.init(ph)
            state, table = carry if swept else (carry, None)
            coef = table if swept else t_step.coef_table(forms, "cpu", F64)
            with torch.no_grad():
                want = t_step.fused_step_reference(forms, state, dt, iters=iters,
                                                   compensated=comp, steps_per_call=2,
                                                   composition=weights, coef=table)
            got = torch.full_like(state, float("nan"))
            code = entry(1, 2 if n == 20 else 3, int(comp) << 1 | int(swept) << 2,
                         coef.data_ptr(), state.data_ptr(), got.data_ptr(), batch, dt,
                         iters[0], iters[1], 2, len(weights),
                         (ctypes.c_double * len(weights))(*weights), None)
            assert code == 0
            scale = torch.ones(state.shape[0], 1, 1, dtype=F64)
            scale[-1] = dt
            assert float(((got - want) * scale).abs().max()) <= 1e-13, (swept, iters)
