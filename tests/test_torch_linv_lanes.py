"""K1's L⁻¹ form on its lanes (``csrc/chain_variants.cu`` cases 2 and 3: n =
20 on 4 lanes a member, n = 5 on 2; ``csrc/chain_lanes.cuh``) and the
straight-line sine of the probe K3b (``csrc/libm_fast.cuh``'s
``sin_fast``), on the CPU.

Each L⁻¹ part is built with g++ in the chain tests' host emulation
(``test_torch_chain_solvers._host_kernel_source``, with
``HOST_ELEMENTARY``) and run through its C entry on CPU tensors, against
the port's plain version bit for bit, the plain version's sin, cos and sqrt
the host build's own (``host_fm``): float32 and float64, (2,0) Kahan,
shared and per-member tables, a member whose angles all lie past
``sincos_fast``'s range (|x| >= 105615), and with per-member tables a
member whose pivots d² lie below the straight-line square root's range
(subnormal: its masses and momenta 1e-39 of the others').  In float32 at n = 5 the lane aux
takes the straight-line sine-cosine, and the library's ``sincosf`` for a
lane with such an angle, the plain version value by value; on the host
the straight-line versions and the host's libm differ by ulps there, so a
lane that kept the straight line would show.  At n = 20 the aux takes the
library's ``sinf`` and ``cosf`` one by one (the straight line read slower
there), and the plain version runs on them.  The generators take the
straight-line square root and reciprocal at both sizes.

``sin_fast`` is built with g++ on its own (the host's ``fma`` and
``nearbyint`` are the card's ``__fmaf_rn`` and ``__float2int_rn``): its
quadrant and sign at every residue of j mod 4, on both sides of each
quadrant edge (x·2/π at a half-integer) up to the range's end, and within
``sinf``'s documented two ulps of float64 ``sin`` there (it is ``sinf`` bit
for bit on the card, ``csrc/libm_check.cu``; on 12 million random floats
of the range it read at most 1.47 ulps, and above one ulp on 0.6 % of
them); the sine half of ``sincos_fast`` alike.
"""

import ctypes
import math
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from hamilton_tpu_torch import kernels
from hamilton_tpu_torch.convert import params_from_numpy, phase_from_numpy
from hamilton_tpu_torch.models import chain
from hamilton_tpu_torch.ops import fused_step as t_step

from test_torch_chain_solvers import (
    HOST_ELEMENTARY, HOST_SHIM, _flags, _host_kernel_source, _layout_query, host_fm,
)

F32, F64 = torch.float32, torch.float64
CSRC = Path(kernels.__file__).resolve().parent.parent / "csrc"
#: n → (the code of ``chain_variants``' C entry, lanes a member, members):
#: small batches, as the host emulation runs a block's lanes as threads
#: with a barrier at each exchange.
CASES = {20: (2, 4, 9), 5: (3, 2, 13)}
#: The member whose every angle lies past the straight-line range, and its
#: first angle (the others 0.1 apart).
FAR_MEMBER, FAR_ANGLE = 3, 2.0e5
#: With per-member tables, the member whose masses and momenta are
#: ``LIGHT_SCALE`` of the others' (the same motion of its angles): its
#: pivots d² are subnormal, below the straight-line square root's range.
LIGHT_MEMBER, LIGHT_SCALE = 5, 1e-39
STEPS = 2
#: n → whether the float32 lane aux takes the straight-line sine-cosine
#: (``csrc/chain_lanes.cuh``: n <= ``kLinvStraightAuxUpTo``, 8), else the
#: library's ``sinf`` and ``cosf`` one by one.
STRAIGHT_AUX = {20: False, 5: True}
#: Appended to the host build beside ``HOST_ELEMENTARY``: the library's float
#: sin (``fn`` 0) and cos (1) value by value, as that aux takes them.
LIBRARY_TRIG = r"""
extern "C" void hamilton_host_library_trig(int fn, const float* in, float* out, long long n) {
  for (long long i = 0; i < n; ++i) out[i] = fn == 0 ? dsin(in[i]) : dcos(in[i]);
}
"""
#: Where ``sincos_fast`` and ``sin_fast`` hold: |x| < 105615.
RANGE_END = 105615.0
#: ``sinf``'s largest error in float32 ulps (the CUDA C++ Programming
#: Guide's table of single-precision functions), which ``sin_fast`` equals.
SINF_ULPS = 2.0


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """The host build of the L⁻¹ part of ``chain_variants.cu`` at ``(n,
    dtype)``, with ``HOST_ELEMENTARY`` appended: ``(library, its C
    entry)``, built at first use."""
    built = {}

    def get(n, dtype):
        if (n, dtype) not in built:
            code = CASES[n][0]
            part = kernels.PARTS["chain_variants"][1](int(dtype == F64), code, False)
            where = tmp_path_factory.mktemp(f"linv_{n}_{part}")
            src = where / "src"
            src.mkdir()
            for header in CSRC.glob("*.cuh"):
                (src / header.name).write_text(header.read_text())
            (src / "chain_variants.cu").write_text((CSRC / "chain_variants.cu").read_text()
                                                   + HOST_ELEMENTARY + LIBRARY_TRIG)
            lib = ctypes.CDLL(str(_host_kernel_source("chain_variants", part, where, csrc=src)))
            entry = lib.hamilton_chain_variant_step
            entry.argtypes = kernels._SIGNATURES["chain_variants"][
                "hamilton_chain_variant_step"]
            built[(n, dtype)] = (lib, entry)
        return built[(n, dtype)]

    return get


def _case(n, dtype, swept, rng):
    """The L⁻¹ chain's forms, its (2,0) Kahan stepper's state and the
    per-member table (None for the shared one) on ``CASES[n]``'s members,
    :data:`FAR_MEMBER` past the straight-line range and, per member,
    :data:`LIGHT_MEMBER` light."""
    batch = CASES[n][2]
    system = chain(n_links=n, fused_solver="linv", device="cpu", dtype=dtype).system
    if swept:
        masses = 1.0 + 0.05 * rng.standard_normal((batch, n))
        masses[LIGHT_MEMBER] *= LIGHT_SCALE
        system = system.replace_params(params_from_numpy({
            "masses": masses,
            "lengths": 1.0 + 0.1 * rng.random((batch, n)),
            "gravity": 5.0 + 0.1 * rng.standard_normal(batch)}, device="cpu", dtype=dtype))
    forms = system.fused_forms(system)
    q = 0.5 + 0.05 * rng.standard_normal((batch, n))
    q[FAR_MEMBER] = FAR_ANGLE + 0.1 * np.arange(n)
    p = 0.3 * rng.standard_normal((batch, n))
    if swept:
        p[LIGHT_MEMBER] *= LIGHT_SCALE
    carry = t_step.fused_stepper(forms, iters=(2, 0), compensated=True).init(
        phase_from_numpy(q, p, device="cpu", dtype=dtype))
    state, table = carry if swept else (carry, None)
    return forms, state, table


def _library_trig(lib, code):
    """The host build's :data:`LIBRARY_TRIG` function ``code`` on a
    float32 tensor."""

    def apply(x):
        x = torch.as_tensor(x).contiguous()
        out = torch.empty_like(x)
        lib.hamilton_host_library_trig(code, ctypes.c_void_p(x.data_ptr()),
                                       ctypes.c_void_p(out.data_ptr()),
                                       ctypes.c_longlong(x.numel()))
        return out

    return apply


@pytest.mark.parametrize("swept", [False, True], ids=["shared", "per_member"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", sorted(CASES))
def test_linv_lane_step_equals_plain_version(host_library, n, dtype, swept, monkeypatch):
    """The host build on its lanes against the plain version run on its
    elementary functions, bit for bit, (2,0) Kahan over two steps, with
    :data:`FAR_MEMBER`'s angles past the straight-line range and, per
    member, :data:`LIGHT_MEMBER`'s pivots below the straight-line square
    root's (the generators' library pass)."""
    lib, entry = host_library(n, dtype)
    host_fm(lib, monkeypatch)
    if dtype == F32 and not STRAIGHT_AUX[n]:
        for code, name in enumerate(("sin", "cos")):
            monkeypatch.setattr(t_step.FM_TORCH, name, _library_trig(lib, code))
    code, lanes, batch = CASES[n]
    layout = (ctypes.c_int * 4)()
    flags = _flags("chain_variants", code, True, swept)
    assert _layout_query(lib, "chain_variants")(int(dtype == F64), code, flags, layout) == 0
    assert layout[0] == lanes and layout[3] == 1  # on its lanes; this part holds it
    forms, state, table = _case(n, dtype, swept, np.random.default_rng(60 + n))
    assert t_step.KERNEL_INSTANTIATIONS[t_step._kernel_key(forms)] == ("chain_variants", code)
    dt = 5e-4
    with torch.no_grad():
        want = t_step.fused_step_reference(forms, state, dt, iters=(2, 0), compensated=True,
                                           steps_per_call=STEPS, coef=table)
    coef = table if swept else t_step.coef_table(forms, "cpu", dtype)
    got = torch.full_like(state, float("nan"))
    assert entry(int(dtype == F64), code, flags, coef.data_ptr(), state.data_ptr(),
                 got.data_ptr(), batch, dt, 2, 0, STEPS, 1, (ctypes.c_double * 1)(1.0),
                 None) == 0
    assert torch.isfinite(want).all()
    assert torch.equal(got, want), float((got - want).abs().max())


# ----------------------------------------------------------------------
# sin_fast, the sine of the probe K3b
# ----------------------------------------------------------------------

SIN_ENTRY = r"""
#include "libm_fast.cuh"
extern "C" void host_sin_fast(int which, const float* x, float* out, long long n) {
  for (long long i = 0; i < n; ++i) {
    float s, c;
    sincos_fast(x[i], &s, &c);
    out[i] = which == 0 ? sin_fast(x[i]) : s;
  }
}
"""


@pytest.fixture(scope="module")
def sin_fast(tmp_path_factory):
    """``sin_fast`` (``which`` 0) and the sine of ``sincos_fast`` (1) built
    with g++ on the chain tests' ``HOST_SHIM``: ``f(which, x)`` on a float32
    numpy array."""
    where = tmp_path_factory.mktemp("sin_fast")
    (where / "cuda_runtime.h").write_text(HOST_SHIM)
    (where / "libm_fast.cuh").write_text((CSRC / "libm_fast.cuh").read_text())
    (where / "sin_fast.cc").write_text(SIN_ENTRY)
    lib_path = where / "libsin_fast.so"
    proc = subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                           "-w", "-I", str(where), "-o", str(lib_path), str(where / "sin_fast.cc")],
                          capture_output=True, text=True)
    if proc.returncode != 0 and "not found" in proc.stderr:
        pytest.skip("needs g++ for the host build of libm_fast.cuh")
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(lib_path))

    def run(which, x):
        x = np.ascontiguousarray(x, dtype=np.float32)
        out = np.empty_like(x)
        lib.host_sin_fast(which, ctypes.c_void_p(x.ctypes.data),
                          ctypes.c_void_p(out.ctypes.data), ctypes.c_longlong(x.size))
        return out

    return run


def _edge_inputs():
    """Floats on both sides of quadrant edges: x·2/π at k + 1/2 for k from
    -4 to 4, a spread of k up to the range's end and the last edges before
    it, and eight floats on each side of each edge."""
    last = int(RANGE_END * 2 / math.pi - 0.5)
    ks = np.concatenate([np.arange(-4, 5), np.linspace(5, last - 8, 200).astype(np.int64),
                         np.arange(last - 8, last + 1)])
    ks = np.concatenate([ks, -ks])
    edges = ((ks + 0.5) * (math.pi / 2)).astype(np.float32)
    steps = np.arange(-8, 9, dtype=np.int32)
    bits = edges.view(np.int32)[:, None] + np.where(edges < 0, -1, 1)[:, None] * steps
    x = bits.astype(np.int32).view(np.float32).ravel()
    return x[np.abs(x) < RANGE_END]


def _quadrant(x):
    """j = rint(x·2/π) in float32, as the reduction rounds it."""
    return np.rint(x * np.float32(2 / math.pi)).astype(np.int64)


def test_sin_fast_quadrants_and_signs_at_the_edges(sin_fast):
    """At each quadrant edge the reduction's j takes both neighbouring
    quadrants, and every residue of j mod 4 occurs; the value's sign is the
    quadrant's (sin r, cos r, −sin r, −cos r at r = x − jπ/2) and the true
    sine's, and the value is ``sincos_fast``'s sine bit for bit."""
    x = _edge_inputs()
    j = _quadrant(x)
    assert set(np.unique(j % 4)) == {0, 1, 2, 3}
    edge = np.rint((x.astype(np.float64) * (2 / math.pi) - 0.5)).astype(np.int64)
    assert set(np.unique(j - edge)) == {0, 1}  # both sides of every edge
    got = sin_fast(0, x)
    assert np.array_equal(got.view(np.int32), sin_fast(1, x).view(np.int32))
    r = x.astype(np.float64) - j * (math.pi / 2)
    assert np.all(np.abs(r) <= math.pi / 4 + 1e-2)
    sign = np.choose(j % 4, [np.sign(r), np.ones_like(r), -np.sign(r), -np.ones_like(r)])
    assert np.array_equal(np.sign(got), sign)
    assert np.array_equal(np.sign(got), np.sign(np.sin(x.astype(np.float64))))


def test_sin_fast_within_sinf_error_up_to_the_range_end(sin_fast):
    """On the edges above, on floats near each multiple of π/2 (where the
    sine is smallest) and on random floats up to the range's end, in both
    signs: within :data:`SINF_ULPS` float32 ulps of float64 ``sin``."""
    rng = np.random.default_rng(18)
    ks = np.concatenate([np.arange(1, 64), rng.integers(64, int(RANGE_END * 2 / math.pi), 400)])
    zeros = (ks * (math.pi / 2)).astype(np.float32)
    near = (zeros.view(np.int32)[:, None] + np.arange(-2, 3, dtype=np.int32)).view(np.float32)
    x = np.concatenate([_edge_inputs(), near.ravel(),
                        rng.uniform(-RANGE_END, RANGE_END, 20000).astype(np.float32),
                        np.float32(10.0) ** rng.uniform(-30, 5, 5000).astype(np.float32)])
    x = np.concatenate([x, -x])
    x = x[np.abs(x) < RANGE_END]
    got = sin_fast(0, x).astype(np.float64)
    ref = np.sin(x.astype(np.float64))
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    err = np.abs(got - ref) / ulp
    assert float(err.max()) <= SINF_ULPS, (float(err.max()), float(x[np.argmax(err)]))
