"""The chain's dense form on G lanes a member (``csrc/dense_lanes.cuh``,
``csrc/fused_step.cu``'s dense chain at n = 20 and 40), on the CPU.

- A plain-PyTorch mirror of the kernel's schedule (the factor right-looking
  column by column, each lane its rows; the forward solve column by column;
  the back solve row by row) against the port's plain ``_chol_entries`` and
  ``_solve_entries`` bit for bit, and against the JAX package's
  ``hamilton_tpu/ops/pallas_solve.py::_chol_entries``/``_solve_entries``.
- The layout entry of the source (lanes, block, shared bytes, blocks an SM).
- The source built with g++ in the chain tests' host emulation
  (``test_torch_chain_solvers._host_kernel_source``: a block as threads, the
  shuffles and ``__syncwarp`` as barriers) and run through its C entry on
  CPU tensors against the plain version: n = 20 in every mode, n = 40 for
  one step bit for bit on the host build's elementary functions.
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hamilton_tpu.ops import pallas_solve as j_solve

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import kernels
from hamilton_tpu_torch.convert import params_from_numpy
from hamilton_tpu_torch.ops import fused_step as t_step

from test_torch_chain_solvers import (
    HOST_ELEMENTARY, _flags, _host_kernel_source, _host_step_matches_plain, _layout_query,
    host_fm,
)

F64, F32 = torch.float64, torch.float32
DENSE_SIZES = (20, 40)


def _part(n, dtype):
    """The ``csrc/fused_step.cu`` part that holds the dense chain at n."""
    return kernels.PARTS["fused_step"][1](int(dtype == F64), n, False)


# ----------------------------------------------------------------------
# The schedule, mirrored in plain PyTorch
# ----------------------------------------------------------------------


def _rows(g, lanes, n, above=-1):
    """Lane ``g``'s rows i > ``above``: i = g, g + lanes, ..."""
    return [i for i in range(g, n, lanes) if i > above]


def lane_factor(k_at, n, lanes, sqrt=torch.sqrt):
    """The kernel's factor on ``lanes`` lanes (``dense_factor_pass``): each
    row's owner forms its entries of K; at column j the owner of row j takes
    d and 1/d, each lane scales its rows' entries of column j, then
    subtracts L_ij·L_kj from its rows' trailing entries (i, k), j < k ≤ i.
    ``({(i, j): L_ij}, [1/d_j])`` as ``_chol_entries`` returns them."""
    a = {}
    for g in range(lanes):
        for i in _rows(g, lanes, n):
            for j in range(i + 1):
                a[(i, j)] = k_at(i, j)
    inv_diag = [None] * n
    for j in range(n):
        d = sqrt(a[(j, j)])
        a[(j, j)] = d
        inv_diag[j] = 1.0 / d
        for g in range(lanes):
            for i in _rows(g, lanes, n, j):
                a[(i, j)] = a[(i, j)] * inv_diag[j]
        for g in range(lanes):
            for i in _rows(g, lanes, n, j):
                for k in range(j + 1, i + 1):
                    a[(i, k)] = a[(i, k)] - a[(i, j)] * a[(k, j)]
    return a, inv_diag


def lane_solve(low, inv_diag, b_at, n, lanes):
    """The kernel's solve on ``lanes`` lanes (``dense_forward_lanes``, then
    ``dense_back_lanes``): forward
    column by column (y_k on its owner, each lane's rows' sums taking
    L_ik·y_k in ascending k), back row by row on the row's owner (x_i's sum
    in ascending k)."""
    acc = {i: b_at(i) for g in range(lanes) for i in _rows(g, lanes, n)}
    for k in range(n):
        acc[k] = acc[k] * inv_diag[k]
        for g in range(lanes):
            for i in _rows(g, lanes, n, k):
                acc[i] = acc[i] - low[(i, k)] * acc[k]
    x = [None] * n
    for i in reversed(range(n)):
        t = acc[i]
        for k in range(i + 1, n):
            t = t - low[(k, i)] * x[k]
        x[i] = t * inv_diag[i]
    return x


def _spd_entries(n, batch, dtype, seed):
    """K = A Aᵀ + n I for ``batch`` random A (well conditioned), as (B,)
    columns of entries, and a right-hand side."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, n, n)) / np.sqrt(n)
    k = a @ a.transpose(0, 2, 1) + np.eye(n)
    b = rng.standard_normal((batch, n))
    return k.astype(np.float64), b


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", DENSE_SIZES)
def test_lane_schedule_equals_plain_entries(n, dtype):
    """The mirror of the kernel's schedule, at 1, 4 and 8 lanes (the lanes a
    member the source is built with among them), equals the port's plain
    ``_chol_entries``/``_solve_entries`` bit for bit: each entry of the factor
    takes its subtractions in ascending column order, each sum of a solve in
    ascending k."""
    k, b = _spd_entries(n, 64, dtype, seed=n)
    kt, bt = torch.as_tensor(k, dtype=dtype), torch.as_tensor(b, dtype=dtype)
    k_at = lambda i, j: kt[:, i, j]  # noqa: E731
    low, inv_d = t_step._chol_entries(k_at, n)
    x = torch.stack(t_step._solve_entries(low, inv_d, lambda i: bt[:, i], n))
    for lanes in (1, 4, 8):
        l2, i2 = lane_factor(k_at, n, lanes)
        assert all(torch.equal(l2[key], low[key]) for key in low), lanes
        assert all(torch.equal(p, q) for p, q in zip(i2, inv_d)), lanes
        x2 = torch.stack(lane_solve(l2, i2, lambda i: bt[:, i], n, lanes))
        assert torch.equal(x2, x), lanes


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("n", DENSE_SIZES)
def test_lane_schedule_matches_reference_entries(n, dtype):
    """The mirror of the kernel's schedule (8 lanes) against the JAX
    package's ``_chol_entries``/``_solve_entries`` run on the CPU on the same
    entries: float64 to 1e-12 and float32 to 1e-5 of the largest factor
    entry and of the largest |x| (K = A Aᵀ + n I: cond(K) is a few
    units, so the float32 solves agree to a few ulps)."""
    k, b = _spd_entries(n, 16, dtype, seed=100 + n)
    np_dtype = np.float64 if dtype == F64 else np.float32
    kj, bj = jnp.asarray(k.astype(np_dtype)), jnp.asarray(b.astype(np_dtype))
    jlow, jinv = j_solve._chol_entries(lambda i, j: kj[:, i, j], n)
    jx = np.stack([np.asarray(v) for v in j_solve._solve_entries(jlow, jinv,
                                                                 lambda i: bj[:, i], n)])
    kt, bt = torch.as_tensor(k, dtype=dtype), torch.as_tensor(b, dtype=dtype)
    low, inv_d = lane_factor(lambda i, j: kt[:, i, j], n, 8)
    x = torch.stack(lane_solve(low, inv_d, lambda i: bt[:, i], n, 8)).numpy()
    tol = 1e-12 if dtype == F64 else 1e-5
    got = np.stack([low[key].numpy() for key in sorted(low)])
    want = np.stack([np.asarray(jlow[key]) for key in sorted(low)])
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    assert np.abs(x - jx).max() <= tol * np.abs(jx).max()


# ----------------------------------------------------------------------
# The source on the host
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def layout_library(tmp_path_factory):
    """``csrc/fused_step.cu`` built with g++ as a part that holds no kernel:
    its layout entry reports each shape with 0 blocks an SM."""
    where = tmp_path_factory.mktemp("dense_layout")
    return ctypes.CDLL(str(_host_kernel_source("fused_step", 99, where)))


def test_dense_lanes_layout(layout_library):
    """The dense chain's lane kernels at n = 20 and 40, each dtype and mode,
    through the source's layout entry: lanes a member a power of two that
    divides a warp; whole groups in a block of 32 to 256 threads; shared
    memory within a block's 232448 bytes that holds every member's slots
    (the packed triangle, the aux's sin and cos and x) and the shared table;
    0 blocks an SM in a part that holds no kernel."""
    query = _layout_query(layout_library, "fused_step")
    out = (ctypes.c_int * 4)()
    for n in DENSE_SIZES:
        for dtype_code, item in ((0, 4), (1, 8)):
            for comp in (False, True):
                for swept in (False, True):
                    assert query(dtype_code, n, _flags("fused_step", n, comp, swept, False),
                                 out) == 0
                    lanes, block, smem, blocks = out
                    assert lanes in (1, 2, 4, 8, 16, 32) and 32 % lanes == 0 and lanes <= n
                    assert block % 32 == 0 and 32 <= block <= 256 and block % lanes == 0
                    slots = n * (n + 1) // 2 + 3 * n
                    members = block // lanes
                    assert (slots * members + n * n + n) * item < smem <= 232448
                    assert blocks == 0


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_dense_lanes_at_20_links_on_the_host(dtype, tmp_path):
    """The dense chain at n = 20 on its lanes, built with g++ in the host
    emulation and run through the source's C entry against the plain version
    (:func:`_host_step_matches_plain`): shared and per-member tables, (2,0)
    Kahan and Suzuki-composed (3,1) without, two steps of 9 members (the
    emulation runs a block's lanes as threads); float64 to 1e-13, float32
    within ``F32_TOL``."""
    lib = ctypes.CDLL(str(_host_kernel_source("fused_step", _part(20, dtype), tmp_path)))
    _host_step_matches_plain(lib, "fused_step", 20, "dense", 20, on_lanes=True, dtype=dtype,
                             batch=9)


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_dense_lanes_at_40_links_bitwise_on_the_host(dtype, tmp_path, monkeypatch):
    """The dense chain at n = 40 on its lanes, built with g++ with
    ``HOST_ELEMENTARY`` and run through the source's C entry: one step of 37
    members, Kahan (2,0) on the shared table and (2,1) on per-member tables,
    equal bit for bit to the plain version on the host build's own sin, cos
    and sqrt (:func:`host_fm`)."""
    csrc = Path(kernels.__file__).resolve().parent.parent / "csrc"
    src = tmp_path / "csrc"
    src.mkdir()
    for header in csrc.glob("*.cuh"):
        (src / header.name).write_text(header.read_text())
    (src / "fused_step.cu").write_text((csrc / "fused_step.cu").read_text() + HOST_ELEMENTARY)
    lib = ctypes.CDLL(str(_host_kernel_source("fused_step", _part(40, dtype), tmp_path,
                                              csrc=src)))
    host_fm(lib, monkeypatch)
    entry = lib.hamilton_fused_step
    entry.argtypes = kernels._SIGNATURES["fused_step"]["hamilton_fused_step"]
    n, batch, dt = 40, 37, 5e-4
    rng = np.random.default_rng(40)
    for iters, swept in (((2, 0), False), ((2, 1), True)):
        system = tp.chain(n_links=n, fused_solver="dense", device="cpu", dtype=dtype).system
        if swept:
            system = system.replace_params(params_from_numpy({
                "masses": 1.0 + 0.05 * rng.standard_normal((batch, n)),
                "lengths": 1.0 + 0.1 * rng.random((batch, n)),
                "gravity": 5.0 + 0.1 * rng.standard_normal(batch)}, device="cpu", dtype=dtype))
        forms = system.fused_forms(system)
        st = t_step.fused_stepper(forms, iters=iters, compensated=True)
        carry = st.init(tp.Phase(torch.as_tensor(0.5 + 0.05 * rng.standard_normal((batch, n)),
                                                 dtype=dtype),
                                 torch.as_tensor(0.3 * rng.standard_normal((batch, n)),
                                                 dtype=dtype)))
        state, table = carry if swept else (carry, None)
        coef = table if swept else t_step.coef_table(forms, "cpu", dtype)
        with torch.no_grad():
            want = t_step.fused_step_reference(forms, state, dt, iters=iters, compensated=True,
                                               coef=table)
        got = torch.full_like(state, float("nan"))
        code = entry(int(dtype == F64), n, _flags("fused_step", n, True, swept, False),
                     coef.data_ptr(), state.data_ptr(), got.data_ptr(), batch, dt, iters[0],
                     iters[1], 1, 1, (ctypes.c_double * 1)(1.0), None)
        assert code == 0
        assert torch.isfinite(want).all()
        assert torch.equal(got, want), (iters, swept, float((got - want).abs().max()))
