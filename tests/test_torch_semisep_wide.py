"""The chain's semiseparable form on its link split (``csrc/semisep_wide.cuh``:
a member's links on G lanes in G warps, each scan handed from lane to lane)
at n = 40 (``csrc/semisep_wide.cu``, the vectors in shared memory) and at
n = 20 (``csrc/fused_step.cu``'s variant 0, the vectors in registers), on
the CPU.

- The port's plain step at n = 40 against the JAX package's
  (``serial_chain_forms_on``: its fused kernel's plain mirror), float64.
- The layout entry of each source (lanes, block, shared bytes, blocks an
  SM).
- Each source built with g++ in the chain tests' host emulation
  (``test_torch_chain_solvers._host_kernel_source``: a block as threads, the
  named barriers of a member's lanes as block-wide ones) and run through its
  C entry on CPU tensors: 37 members, bit for bit the plain version on the
  host build's own sin, cos and sqrt (``HOST_ELEMENTARY``), at the lanes a
  member each dtype ships and at another.  The kernel runs every product
  and sum of ``chain_forms.cuh``'s forms in their order (the lanes hand a
  scan's running values on; no sum is split), so the plain version is its
  mirror; the host build contracts nothing, as ``semisep_wide.cu`` is built
  on the card (``fused_step.cu``'s part at n = 20 keeps nvcc's contraction,
  held on the card to ``chip_smoke.TOL``).
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamilton_tpu import models as jmodels
from hamilton_tpu.ops import pallas_step as j_step
from hamilton_tpu.state import Phase as JPhase

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import kernels
from hamilton_tpu_torch.convert import params_from_numpy, phase_from_numpy
from hamilton_tpu_torch.ops import fused_step as t_step

from test_torch_chain_solvers import (
    HOST_ELEMENTARY, _flags, _host_kernel_source, _layout_query, host_fm,
)

F64, F32 = torch.float64, torch.float32
N = 40
SOURCE = "semisep_wide"
CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"
#: n → (the source that holds the link split there, its lanes constant's
#: stem, float and double: ``<stem>F``, ``<stem>D``)
SOURCES = {40: (SOURCE, "kWideLanes"), 20: ("fused_step", "kWide20Lanes")}


def _shipped_lanes(n=N):
    """``{dtype_code: lanes a member}`` at n as its source ships them (0:
    the one-thread template)."""
    source, stem = SOURCES[n]
    text = (CSRC / f"{source}.cu").read_text()
    return {code: int(re.search(rf"\b{stem}{letter} = (\d+)", text).group(1))
            for code, letter in ((0, "F"), (1, "D"))}


def _reference_replay(stepper):
    """The JAX package's plain mirror of its fused kernel for ``stepper``
    (``pallas_step.py``'s ``_replay``: the same arithmetic on (B,) member
    columns, which its custom VJP differentiates), taken from the
    stepper's ``step``: its kernel step's backward closes over it.  Run
    eagerly it takes seconds at n = 40, where the kernel in interpret mode
    takes ~100 s to compile on the CPU."""

    def cells(fn):
        return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))

    return cells(cells(stepper.step)["_kernel_step"].bwd)["_replay"]


def test_plain_step_matches_reference():
    """One (2,0) Kahan step of 1024 members of the reference's stress chain
    (n = 40, float64): the port's plain version against the JAX package's
    plain mirror of its fused kernel, run eagerly on the CPU, to 1e-12
    (``dt·vdot_est`` as the velocity difference the kernel computes)."""
    jex = jmodels.chain(n_links=N, fused_solver="semiseparable")
    tsys = tp.chain(n_links=N, fused_solver="semiseparable", device="cpu", dtype=F64).system
    tsys = tsys.replace_params(params_from_numpy(
        {k: np.asarray(v) for k, v in jex.system.params.items()}, device="cpu", dtype=F64))
    rng = np.random.default_rng(40)
    q = np.asarray(jex.init_config.q) + 0.01 * rng.standard_normal((1024, N))
    p = 0.05 * rng.standard_normal((1024, N))
    dt = 5e-4
    jst = j_step.fused_stepper(jex.system.fused_forms(jex.system), iters=(2, 0),
                               compensated=True)
    with jax.disable_jit():
        jc = _reference_replay(jst)(jnp.full((8, 128), dt, jnp.float64),
                                    *jst.init(JPhase(jnp.asarray(q), jnp.asarray(p))))
    # the reference's (G, n, 8, 128) carry tiles → (B, n)
    jc = [np.moveaxis(np.asarray(t), 1, 3).reshape(-1, N) for t in jc]
    tst = tp.make_stepper(tsys, "leapfrog_fused", iters=(2, 0), compensated=True)
    tc = tst.step(tst.init(phase_from_numpy(q, p, device="cpu", dtype=F64)), dt)
    assert tc.shape == (len(jc), N, 1024)
    for v, ref in enumerate(jc):
        got = tc[v].T.numpy()
        if v == len(jc) - 1:
            np.testing.assert_allclose(dt * got, dt * ref, rtol=0, atol=1e-12)
        elif v == len(jc) - 2:
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-12 * max(1.0, float(np.abs(ref).max())))
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_layout_of_the_kernel_source(tmp_path):
    """The layout each source reports through its C entry (built with g++, a
    part that holds no kernel), each dtype and mode.  On the link split: the
    lanes it ships, whole warps of members a lane (lane g of member m is
    thread g·M + m), at most 256 threads, and shared memory within a
    block's 232448 bytes; at n = 40 it holds each member's ten (float) or
    eleven (float64) n-vectors and the shared table, at n = 20 (the vectors
    in registers) only the member's carries and the table; float32 one wave
    of 16384 members on 132 SMs.  At n = 20 a dtype the source keeps on the
    one-thread template reports it (1 lane, 128 threads, the per-member
    table staged).  0 blocks an SM where the part holds no kernel; -1 for
    another n or the dense form (``semisep_wide.cu``), -2 for bad flags."""
    out = (ctypes.c_int * 4)()
    for n, (source, _) in SOURCES.items():
        (tmp_path / source).mkdir()
        query = _layout_query(ctypes.CDLL(str(_host_kernel_source(source, 99,
                                                                  tmp_path / source))), source)
        lanes_of = _shipped_lanes(n)
        for dtype_code, item in ((0, 4), (1, 8)):
            for comp in (False, True):
                for swept in (False, True):
                    assert query(dtype_code, n, _flags("fused_step", n, comp, swept, True),
                                 out) == 0
                    lanes, block, smem, blocks = out
                    assert blocks == 0
                    if lanes_of[dtype_code] == 0:  # the one-thread template
                        assert (lanes, block) == (1, 128)
                        assert smem == (3 * n * 128 * item if swept else 0)
                        continue
                    members = block // lanes
                    assert lanes == lanes_of[dtype_code] and block % lanes == 0
                    assert members % 32 == 0 and block <= 256
                    if n == 40:
                        assert (10 * n * members + 3 * n) * item <= smem <= 232448
                        if dtype_code == 0:
                            assert members * (233472 // (smem + 1024)) * 132 >= 16384
                    else:
                        assert smem == ((11 * members if lanes > 1 else 0) + 3 * n) * item
                        if dtype_code == 0:
                            assert members * 132 >= 16384
    query = _layout_query(ctypes.CDLL(str(tmp_path / SOURCE / f"lib{SOURCE}_host.so")), SOURCE)
    assert query(0, 20, 1, out) == -1 and query(0, N, 0, out) == -1
    assert query(0, N, 9, out) == -2


@pytest.fixture(scope="module")
def host_sources(tmp_path_factory):
    """This checkout's sources with ``HOST_ELEMENTARY`` appended to the
    source that holds the link split at n, once a lanes setting: ``{(n,
    dtype_code, lanes): directory}``, the source's lanes constant set to
    it."""
    made = {}

    def make(n, dtype_code, lanes):
        if (n, dtype_code, lanes) not in made:
            source, stem = SOURCES[n]
            src = tmp_path_factory.mktemp(f"csrc{n}d{dtype_code}g{lanes}")
            for header in CSRC.glob("*.cuh"):
                (src / header.name).write_text(header.read_text())
            name = f"{stem}{'FD'[dtype_code]}"
            text, count = re.subn(rf"\b{name} = \d+", f"{name} = {lanes}",
                                  (CSRC / f"{source}.cu").read_text())
            assert count == 1
            (src / f"{source}.cu").write_text(text + HOST_ELEMENTARY)
            made[(n, dtype_code, lanes)] = src
        return made[(n, dtype_code, lanes)]

    return make


# (n, dtype, lanes a member): at n = 40 each dtype's shipped lanes (float32
# 2, float64 4) and one other (float64 holds a lane's register vectors only
# from G = 2); at n = 20 each dtype's shipped lanes (2) and float32 on one
HOST_CASES = [(40, F32, 2), (40, F32, 1), (40, F64, 4), (40, F64, 2),
              (20, F32, 2), (20, F32, 1), (20, F64, 2)]


@pytest.mark.parametrize("n,dtype,lanes", HOST_CASES,
                         ids=["f32-G2", "f32-G1", "f64-G4", "f64-G2",
                              "n20-f32-G2", "n20-f32-G1", "n20-f64-G2"])
def test_kernel_bitwise_on_the_host(n, dtype, lanes, host_sources, tmp_path, monkeypatch):
    """The link split built with g++ in the host emulation and run through
    its source's C entry on 37 members (one block, the last members past the
    batch): Kahan (2,0) on the shared table over two steps a launch (the
    second on the carried factor), Kahan (2,1) on per-member tables, and
    Suzuki-composed (3,1) without Kahan, each equal bit for bit to the plain
    version on the host build's own sin, cos and sqrt (:func:`host_fm`)."""
    dtype_code = int(dtype == F64)
    source = SOURCES[n][0]
    where = tmp_path / "build"
    where.mkdir()
    part = kernels.PARTS[source][1](dtype_code, n, True)
    lib = ctypes.CDLL(str(_host_kernel_source(source, part, where,
                                              csrc=host_sources(n, dtype_code, lanes))))
    host_fm(lib, monkeypatch)
    layout = (ctypes.c_int * 4)()
    for flags in (3, 7):
        assert _layout_query(lib, source)(dtype_code, n, flags, layout) == 0
        assert layout[0] == lanes and layout[3] == 1
    entry_name = "hamilton_semisep_wide_step" if n == N else "hamilton_fused_step"
    entry = getattr(lib, entry_name)
    entry.argtypes = kernels._SIGNATURES[source][entry_name]
    batch, dt = 37, 5e-4
    rng = np.random.default_rng(41)
    for iters, comp, swept, weights, steps in (((2, 0), True, False, (1.0,), 2),
                                               ((2, 1), True, True, (1.0,), 1),
                                               ((3, 1), False, False,
                                                t_step.SUZUKI4_COMPOSITION, 1)):
        system = tp.chain(n_links=n, fused_solver="semiseparable", device="cpu",
                          dtype=dtype).system
        if swept:
            system = system.replace_params(params_from_numpy({
                "masses": 1.0 + 0.05 * rng.standard_normal((batch, n)),
                "lengths": 1.0 + 0.1 * rng.random((batch, n)),
                "gravity": 5.0 + 0.1 * rng.standard_normal(batch)}, device="cpu", dtype=dtype))
        forms = system.fused_forms(system)
        st = t_step.fused_stepper(forms, iters=iters, compensated=comp, composition=weights)
        carry = st.init(tp.Phase(
            torch.as_tensor(0.5 + 0.05 * rng.standard_normal((batch, n)), dtype=dtype),
            torch.as_tensor(0.3 * rng.standard_normal((batch, n)), dtype=dtype)))
        state, table = carry if swept else (carry, None)
        coef = table if swept else t_step.coef_table(forms, "cpu", dtype)
        kw = dict(iters=iters, compensated=comp, steps_per_call=steps, composition=weights)
        with torch.no_grad():
            want = t_step.fused_step_reference(forms, state, dt, coef=table, **kw)
        got = torch.full_like(state, float("nan"))
        code = entry(dtype_code, n, _flags("fused_step", n, comp, swept, True), coef.data_ptr(),
                     state.data_ptr(), got.data_ptr(), batch, dt, iters[0], iters[1], steps,
                     len(weights), (ctypes.c_double * len(weights))(*weights), None)
        assert code == 0
        assert torch.isfinite(want).all()
        assert torch.equal(got, want), (iters, swept, float((got - want).abs().max()))
