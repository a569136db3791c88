"""The port's batched tiny-SPD entries (``hamilton_tpu_torch/ops/batched_spd.py``,
K2a-K2e) against the JAX package's, on the CPU.

On a CPU tensor each entry runs its plain PyTorch version, which computes the
reference kernels' operations (``_chol_entries``/``_solve_entries``, and
``_k_at_from_jac`` for the J entries) in the same order.  The reference's
entries run their Pallas kernels in interpret mode, as ``tests/test_pallas.py``
runs them; their padding path is taken with B=1100.  Inputs are made with
numpy from a seed.  The J entries are held to n ∈ {3, 8}: the interpreter
compiles the unrolled K formation of n=20, m=40 for over ten minutes.

The kernel source itself (``csrc/batched_spd.cu``) is rehearsed here too:
built with g++ in the host emulation of ``test_torch_chain_solvers.py`` and
run through its C entries on CPU tensors against the plain versions, bit for
bit.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hamilton_tpu.ops import pallas_solve as ps
from hamilton_tpu.ops.linalg import _masked_cho_solve, _masked_cholesky

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import kernels
from hamilton_tpu_torch import mechanics as tmech
from hamilton_tpu_torch.ops import batched_spd as bs
from hamilton_tpu_torch.ops import linalg as tlinalg

from test_torch_chain_solvers import HOST_SHIM

# float32 against the interpreted kernels: the same operations in the same
# order, but XLA's CPU code fuses multiplies and adds (one rounding instead
# of two), and the solves carry those ulps through cond(K) (≲ 30 for these
# inputs).  The readings, relative to each output's largest value, are 5e-8
# to 4.3e-7; the limit sits about 10x above the largest.
F32_RTOL = 5e-6
# float64 against the reference's masked-loop factorization (another order
# of the same sums) on well-conditioned K: rounding, at most ~1e-14.
F64_ATOL = 1e-12


def _spd(rng, b, n, dtype):
    a = rng.standard_normal((b, n, n))
    return (np.einsum("bij,bkj->bik", a, a) + n * np.eye(n)).astype(dtype)


def _jac(rng, b, n, m, dtype):
    """A random (m, n) Jacobian whose K is well conditioned (as ``_spd``'s K
    is, through its ``n·I``), so that rounding is not amplified, and an
    inertia vector."""
    j = 0.1 * rng.standard_normal((b, m, n))
    j[:, :n] += np.eye(n)
    return j.astype(dtype), rng.uniform(1.0, 2.0, m).astype(dtype)


def _close(want, got, rtol=F32_RTOL):
    want = np.asarray(want, dtype=np.float64)
    got = got.numpy().astype(np.float64)
    assert want.shape == got.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("n", [3, 8, 20])
def test_k_entries_match_the_reference_kernels(n):
    """K2a-K2c against ``spd_solve_pallas``/``cholesky_pallas``/
    ``cho_solve_pallas`` on a ragged batch (the reference pads it)."""
    rng = np.random.default_rng(n)
    b = 1100
    k = _spd(rng, b, n, np.float32)
    vec = rng.standard_normal((b, n)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jx = ps.spd_solve_pallas(jnp.asarray(k), jnp.asarray(vec))
        jl = ps.cholesky_pallas(jnp.asarray(k))
        jxc = ps.cho_solve_pallas(jl, jnp.asarray(vec))
    tk, tv = torch.tensor(k), torch.tensor(vec)
    tl = bs.cholesky_batched(tk)
    _close(jx, bs.spd_solve_batched(tk, tv))
    _close(jl, tl)
    _close(jxc, bs.cho_solve_batched(tl, tv))


def test_tile_entries_match_the_reference_kernels():
    """The reference's tile-layout entries compute the same as its
    member-major ones; the port has only the member-major layout."""
    rng = np.random.default_rng(1)
    n, b = 6, 1024
    k = _spd(rng, b, n, np.float32)
    vec = rng.standard_normal((b, n)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        kt, vt = ps._to_tiles(jnp.asarray(k), 2), ps.to_vec_tiles(jnp.asarray(vec))
        jx = ps.from_vec_tiles(ps.spd_solve_tiles(kt, vt))
        jlt = ps.cholesky_tiles(kt)
        jxc = ps.from_vec_tiles(ps.cho_solve_tiles(jlt, vt))
    tk, tv = torch.tensor(k), torch.tensor(vec)
    _close(jx, bs.spd_solve_batched(tk, tv))
    _close(ps._from_tiles(jlt, (n, n)), bs.cholesky_batched(tk))
    _close(jxc, bs.cho_solve_batched(bs.cholesky_batched(tk), tv))


@pytest.mark.parametrize("n", [3, 8])
def test_jac_entries_match_the_reference_kernels(n):
    """K2d and K2e against ``spd_solve_jac_tiles``/``cholesky_jac_tiles``,
    with ``jac_scaled`` against ``jac_tiles`` (m = n + 2 Cartesian rows: the
    interpreter's compile time grows with m·n²)."""
    rng = np.random.default_rng(10 + n)
    b, m = 1024, n + 2
    j, inertia = _jac(rng, b, n, m, np.float32)
    vec = rng.standard_normal((b, n)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        jt = ps.jac_tiles(jnp.asarray(j), jnp.asarray(inertia))
        jx = ps.from_vec_tiles(ps.spd_solve_jac_tiles(jt, ps.to_vec_tiles(jnp.asarray(vec)), n, m))
        jl = ps._from_tiles(ps.cholesky_jac_tiles(jt, n, m), (n, n))
    js = bs.jac_scaled(torch.tensor(j), torch.tensor(inertia))
    _close(ps._from_tiles(jt, (m, n)), js)
    _close(jx, bs.spd_solve_jac(js, torch.tensor(vec)))
    _close(jl, bs.cholesky_jac(js))


@pytest.mark.parametrize("n", [3, 8, 20])
def test_float64_matches_the_masked_factorization(n):
    """All five entries in float64 against the reference's mathematical
    reference for its kernels, ``_masked_cholesky``/``_masked_cho_solve``."""
    rng = np.random.default_rng(20 + n)
    b = 64
    k = _spd(rng, b, n, np.float64)
    j, inertia = _jac(rng, b, n, 2 * n, np.float64)
    vec = rng.standard_normal((b, n))
    kj = np.einsum("bmi,m,bmj->bij", j, inertia, j)
    jl, jlj = _masked_cholesky(jnp.asarray(k)), _masked_cholesky(jnp.asarray(kj))
    want = {
        "spd_solve_batched": _masked_cho_solve(jl, jnp.asarray(vec)),
        "cholesky_batched": jl,
        "cho_solve_batched": _masked_cho_solve(jl, jnp.asarray(vec)),
        "spd_solve_jac": _masked_cho_solve(jlj, jnp.asarray(vec)),
        "cholesky_jac": jlj,
    }
    tk, tv = torch.tensor(k), torch.tensor(vec)
    js = bs.jac_scaled(torch.tensor(j), torch.tensor(inertia))
    got = {
        "spd_solve_batched": bs.spd_solve_batched(tk, tv),
        "cholesky_batched": bs.cholesky_batched(tk),
        "cho_solve_batched": bs.cho_solve_batched(bs.cholesky_batched(tk), tv),
        "spd_solve_jac": bs.spd_solve_jac(js, tv),
        "cholesky_jac": bs.cholesky_jac(js),
    }
    for name in want:
        np.testing.assert_allclose(np.asarray(want[name]), got[name].numpy(), rtol=0,
                                   atol=F64_ATOL, err_msg=name)


def test_batch_axes_and_a_matrix_that_is_not_spd():
    """Any leading batch axes; a member that is not SPD gets NaN and no
    other member is touched."""
    rng = np.random.default_rng(3)
    k = torch.tensor(_spd(rng, 12, 5, np.float64)).reshape(3, 4, 5, 5)
    vec = torch.tensor(rng.standard_normal((3, 4, 5)))
    good = bs.spd_solve_batched(k, vec)
    assert good.shape == (3, 4, 5) and bs.cholesky_batched(k).shape == (3, 4, 5, 5)
    bad = k.clone()
    bad[1, 2] = -bad[1, 2]
    for x in (bs.spd_solve_batched(bad, vec),
              bs.cho_solve_batched(bs.cholesky_batched(bad), vec)):
        nan = torch.isnan(x).any(-1)
        assert nan[1, 2] and int(nan.sum()) == 1
        keep = ~nan
        assert torch.equal(x[keep], good[keep])


def test_backward_raises_and_unported_types():
    """What the entries refuse: bfloat16 (not ported), other dtypes, n > 32,
    no batch axis, a device with neither kernel nor plain version.  The
    backward no longer raises: it fills the gradients."""
    rng = np.random.default_rng(4)
    k = torch.tensor(_spd(rng, 4, 3, np.float64), requires_grad=True)
    vec = torch.tensor(rng.standard_normal((4, 3)))
    x = bs.spd_solve_batched(k, vec)
    x.sum().backward()
    assert k.grad is not None and bool(torch.isfinite(k.grad).all())
    with pytest.raises(NotImplementedError, match="M10"):
        bs.cholesky_batched(k.detach().to(torch.bfloat16))
    with pytest.raises(ValueError, match="float32 or float64"):
        bs.cholesky_batched(k.detach().half())
    with pytest.raises(ValueError, match="n <= 32"):
        bs.cholesky_batched(torch.eye(33, dtype=torch.float64).expand(2, 33, 33))
    with pytest.raises(ValueError, match="batch axes"):
        bs.cholesky_batched(k.detach()[0])
    with pytest.raises(ValueError, match="device meta"):
        bs.cholesky_batched(torch.empty(2, 3, 3, device="meta", dtype=torch.float64))


# ----------------------------------------------------------------------
# Gradients
# ----------------------------------------------------------------------


def _sym(a):
    return (a + a.mT) / 2


def _grad_operands(entry, rng, b, n, dtype):
    """An entry's differentiable operands (float64 or float32): a symmetric
    K seen through its lower triangle, a lower factor, or √M·J; and b."""
    k = torch.tensor(_spd(rng, b, n, np.float64))
    j, inertia = _jac(rng, b, n, 2 * n, np.float64)
    vec = torch.tensor(rng.standard_normal((b, n)))
    src = {"spd_solve_batched": k, "cholesky_batched": k,
           "cho_solve_batched": torch.linalg.cholesky(k),
           "spd_solve_jac": bs.jac_scaled(torch.tensor(j), torch.tensor(inertia)),
           "cholesky_jac": bs.jac_scaled(torch.tensor(j), torch.tensor(inertia))}[entry.name]
    args = (src, vec) if entry.solves else (src,)
    return tuple(a.to(dtype).requires_grad_(True) for a in args)


@pytest.mark.parametrize("entry", bs.ENTRIES, ids=[e.name for e in bs.ENTRIES])
def test_gradcheck(entry):
    """Each entry's backward against finite differences in float64.  The
    entries read K's lower triangle only (the kernels' convention), so K2a
    is checked through a symmetric K: its one-sided ``gK = −gb xᵀ`` is the
    reference's."""
    rng = np.random.default_rng(30)
    args = _grad_operands(entry, rng, 3, 4, torch.float64)
    fn = ((lambda k, b: entry.entry(_sym(k), b)) if entry.name == "spd_solve_batched"
          else entry.entry)
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-7, rtol=1e-6)


# the reference's K2 entries under jax.vjp (interpret mode), as tests/test_pallas.py
# differentiates them, in float32: K2a-K2c at n = 4, K2d/K2e at n = 3, m = 6
_J_VJPS = {
    "spd_solve_batched": lambda k, b: ps.spd_solve_pallas(k, b),
    "cholesky_batched": lambda k: ps.cholesky_pallas(k),
    "cho_solve_batched": lambda low, b: ps.cho_solve_pallas(low, b),
    "spd_solve_jac": lambda js, b: ps.from_vec_tiles(ps.spd_solve_jac_tiles(
        ps._to_tiles(js, 2), ps.to_vec_tiles(b), js.shape[-1], js.shape[-2])),
    "cholesky_jac": lambda js: ps._from_tiles(ps.cholesky_jac_tiles(
        ps._to_tiles(js, 2), js.shape[-1], js.shape[-2]), (js.shape[-1],) * 2),
}


@pytest.mark.parametrize("entry", bs.ENTRIES, ids=[e.name for e in bs.ENTRIES])
def test_vjp_matches_the_reference_entry(entry):
    """Each entry's gradient for a random cotangent against the JAX entry's
    custom VJP on the same float32 inputs: the same formulas (the solves'
    ``gb = K⁻¹g`` by the entry itself, the factors' pullback through the
    masked Cholesky), agreeing to float32 rounding through cond(K)."""
    import jax

    rng = np.random.default_rng(31)
    n = 3 if entry.from_jac else 4
    args = _grad_operands(entry, rng, 1024, n, torch.float32)
    out = entry.entry(*args)
    g = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    got = torch.autograd.grad(out, args, torch.tensor(g))
    with pltpu.force_tpu_interpret_mode():
        _, pullback = jax.vjp(_J_VJPS[entry.name],
                              *[jnp.asarray(a.detach().numpy()) for a in args])
        want = pullback(jnp.asarray(g))
    for w, t in zip(want, got):
        _close(w, t, rtol=2e-5)


def test_gradients_compose_with_torch_func():
    """The entries are ``forward`` + ``setup_context`` Functions: torch.func's
    grad and vjp run their backwards as ``.backward()`` does."""
    rng = np.random.default_rng(32)
    k = torch.tensor(_spd(rng, 5, 4, np.float64))
    vec = torch.tensor(rng.standard_normal((5, 4)))

    def loss(kk, bb):
        low = bs.cholesky_batched(kk)
        return (bs.cho_solve_batched(low, bb) ** 2).sum() + bs.spd_solve_batched(kk, bb).sum()

    gk, gb = torch.func.grad(loss, argnums=(0, 1))(k, vec)
    kr, br = k.clone().requires_grad_(True), vec.clone().requires_grad_(True)
    wk, wb = torch.autograd.grad(loss(kr, br), (kr, br))
    torch.testing.assert_close(gk, wk, rtol=0, atol=1e-13)
    torch.testing.assert_close(gb, wb, rtol=0, atol=1e-13)


def test_masked_cholesky_matches_the_reference():
    """The out-of-place masked Cholesky (the factors' pullback) against the
    reference's ``_masked_cholesky``, value and VJP, float64."""
    import jax

    rng = np.random.default_rng(33)
    k = _spd(rng, 8, 6, np.float64)
    g = rng.standard_normal(k.shape)
    jl, pullback = jax.vjp(_masked_cholesky, jnp.asarray(k))
    tk = torch.tensor(k, requires_grad=True)
    tl = bs.masked_cholesky(tk)
    (tg,) = torch.autograd.grad(tl, tk, torch.tensor(g))
    np.testing.assert_allclose(np.asarray(jl), tl.detach().numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(pullback(jnp.asarray(g))[0]), tg.numpy(),
                               rtol=0, atol=1e-11)


@pytest.mark.parametrize("n,batched,k_rhs", [(2, True, None), (1, True, None),
                                             (5, False, None), (5, True, 2), (33, True, None)],
                         ids=["closed-form-2", "closed-form-1", "unbatched", "matrix-rhs",
                              "n33"])
def test_linalg_branches_carry_gradients(n, batched, k_rhs):
    """``ops.linalg``'s routes that do not reach the entries (the n ≤ 2
    closed forms and ``torch.linalg``) differentiate as plain PyTorch: their
    gradient equals ``torch.linalg.solve``'s on a symmetric K."""
    rng = np.random.default_rng(34 + n)
    k = torch.tensor(_spd(rng, 3, n, np.float64))
    k = k if batched else k[0]
    rhs = torch.tensor(rng.standard_normal(k.shape[:-1] + ((k_rhs,) if k_rhs else ())))
    grads = []
    for solve in (lambda kk, bb: tlinalg.small_cho_solve(tlinalg.small_cholesky(kk), bb),
                  lambda kk, bb: tlinalg.spd_solve(kk, bb),
                  lambda kk, bb: torch.linalg.solve(kk, bb if k_rhs else bb[..., None])
                  .reshape(bb.shape)):
        kk, bb = k.clone().requires_grad_(True), rhs.clone().requires_grad_(True)
        out = solve(_sym(kk), bb)
        grads.append(torch.autograd.grad((out ** 2).sum(), (kk, bb)))
    for got in grads[:2]:
        for a, b in zip(got, grads[2]):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def _record(monkeypatch, module, names):
    """Count the calls ``module`` makes to the entries in ``names``."""
    calls = {name: 0 for name in names}
    for name in names:
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(module, name, counted)
    return calls


def test_linalg_dispatch(monkeypatch):
    """n ≤ 2 closed forms; 3 ≤ n ≤ 32 batched vector solves to the entries;
    unbatched, matrix right-hand sides and n > 32 to torch.linalg."""
    calls = _record(monkeypatch, tlinalg,
                    ["spd_solve_batched", "cholesky_batched", "cho_solve_batched"])
    rng = np.random.default_rng(5)

    def solve(b, n, k_rhs=None):
        k = torch.tensor(_spd(rng, max(b, 1), n, np.float64))
        k = k if b else k[0]
        rhs = torch.tensor(rng.standard_normal(k.shape[:-1] + ((k_rhs,) if k_rhs else ())))
        want = torch.linalg.solve(k, rhs if k_rhs else rhs[..., None])
        got = tlinalg.spd_solve(k, rhs)
        torch.testing.assert_close(got, want if k_rhs else want[..., 0], rtol=0, atol=1e-12)
        low = tlinalg.small_cholesky(k)
        torch.testing.assert_close(tlinalg.small_cho_solve(low, rhs), got, rtol=0, atol=1e-12)

    solve(6, 2)
    assert calls == {"spd_solve_batched": 0, "cholesky_batched": 0, "cho_solve_batched": 0}
    solve(6, 3)
    solve(6, 32)
    assert calls == {"spd_solve_batched": 2, "cholesky_batched": 2, "cho_solve_batched": 2}
    solve(0, 5)
    solve(6, 5, k_rhs=2)
    solve(6, 33)
    assert calls == {"spd_solve_batched": 2, "cholesky_batched": 3, "cho_solve_batched": 2}


def test_mechanics_take_the_reference_routes(monkeypatch):
    """A system with ``mass_matrix_fn`` (chain) solves with K (K2a-K2c); one
    without (spring) hands √M·J to K2d and K2e and never forms K."""
    k_calls = _record(monkeypatch, tlinalg,
                      ["spd_solve_batched", "cholesky_batched", "cho_solve_batched"])
    j_calls = _record(monkeypatch, tmech, ["spd_solve_jac", "cholesky_jac"])
    formed = _record(monkeypatch, tmech, ["_form_k"])
    rng = np.random.default_rng(6)
    for ex, n in ((tp.chain(n_links=4, device="cpu", dtype=torch.float64), 4),
                  (tp.spring(device="cpu", dtype=torch.float64), 3)):
        q = ex.init_config.q + 0.1 * torch.tensor(rng.standard_normal((5, n)))
        ph = tp.Phase(q, torch.tensor(rng.standard_normal((5, n))))
        tmech.ham_eqs(ex.system, ph)
        tmech.velocities(ex.system, ph)
        fac = tmech.q_factor(ex.system, q)
        tmech.dhdq_factored(ex.system, fac, q, ph.p)
        tmech.dhdp_factored(fac, ph.p)
    assert k_calls == {"spd_solve_batched": 2, "cholesky_batched": 1, "cho_solve_batched": 4}
    assert j_calls == {"spd_solve_jac": 2, "cholesky_jac": 1}
    assert formed == {"_form_k": 0}


# ----------------------------------------------------------------------
# The kernel source on the host
# ----------------------------------------------------------------------

#: Threads a block for each count of lanes a member that the host build is
#: run at: a tile of several members, so that a batch of 37 on the host's
#: four SMs ends in a tile part full.
HOST_TILE_THREADS = {1: 64, 2: 64, 4: 64, 8: 64, 32: 128}


def _host_spd_library(where: Path, lanes=None) -> Path:
    """``csrc/batched_spd.cu`` as a host library: g++ through ``HOST_SHIM``,
    the dynamic shared memory a static buffer, each launch a loop over
    blocks of threads.  With ``lanes``, every entry of the K2b and K2c
    tables (``kFactorShape``, ``kSubstituteShape``) set to that many lanes
    a member and ``HOST_TILE_THREADS`` threads a block, as
    ``scripts/k2_sweep.py`` builds its variants; else the source's own."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the host build of the kernel source")
    csrc = Path(kernels.__file__).resolve().parent.parent / "csrc"
    (where / "cuda_runtime.h").write_text(HOST_SHIM)
    for h in csrc.glob("*.cuh"):
        (where / h.name).write_text(h.read_text())
    src = (csrc / "batched_spd.cu").read_text()
    if lanes is not None:
        shape = "{%d, %d}" % (lanes, HOST_TILE_THREADS[lanes])
        table = "{{%s}, {%s}}" % ((", ".join([shape] * 3),) * 2)
        src, count = re.subn(r"(k(?:Factor|Substitute)Shape\[2\]\[3\] = )\{.*?\};",
                             lambda m: f"{m.group(1)}{table};", src, flags=re.S)
        assert count == 2
    src, shared = re.subn(r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
                          r"alignas(16) static unsigned char \1[1 << 18];", src)
    src, launches = re.subn(r"(\w+)<<<(.*?),(.*?),.*?>>>\((.*?)\);",
                            lambda m: f"HOST_LAUNCH({m.group(2)}, {m.group(3)}, "
                                      f"{m.group(1)}({m.group(4)}));", src, flags=re.S)
    # scratch() and the two tile kernels; the one-thread and the tile launch
    assert shared == 3 and launches == 2
    (where / "batched_spd.cc").write_text(src)
    lib = where / "libbatched_spd_host.so"
    proc = subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                           "-w", "-pthread", "-I", str(where), "-o", str(lib),
                           str(where / "batched_spd.cc")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = ctypes.CDLL(str(lib))
    for fn, argtypes in kernels._SIGNATURES["batched_spd"].items():
        getattr(out, fn).argtypes = argtypes
    return out


def _offset(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a view one member into a larger tensor: its first value off a
    16-byte boundary for most n, so the staging's unaligned ends run."""
    big = torch.empty((t.shape[0] + 1,) + tuple(t.shape[1:]), dtype=t.dtype)
    big[1:] = t
    return big[1:]


def _same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    return bool(((got == want) | (torch.isnan(got) & torch.isnan(want))).all())


def _ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root (numpy's) of a CPU tensor: NaN
    below 0, as ``torch.sqrt``."""
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.sqrt(x.numpy()))


@pytest.mark.parametrize("lanes", [None, 1, 2, 4, 8, 32],
                         ids=["shipped", "G1", "G2", "G4", "G8", "G32"])
def test_tile_kernels_on_the_host(lanes, tmp_path, monkeypatch):
    """K2b and K2c (``hamilton_spd_factor`` with ``from_j = 0`` and
    ``hamilton_spd_substitute``) built with g++ in the host emulation, at
    the source's own lanes a member and at each count the sweep tries: at
    n = 1, 2, 3, 20 and 32, float32 and float64, on 37 members (the last
    tile part full) lying off a 16-byte boundary, each equal to
    ``cholesky_plain`` and ``cho_solve_plain`` bit for bit.  One member that
    is not SPD: NaN in that member, every other member still equal.

    The plain versions run here with a correctly rounded ``torch.sqrt``, as
    on the card: PyTorch's vectorized CPU square root can be an ulp off
    (AVX-512: sqrt(8.165938262201326) in float64 comes out one ulp low)."""
    lib = _host_spd_library(tmp_path, lanes)
    monkeypatch.setattr(torch, "sqrt", _ieee_sqrt)
    rng = np.random.default_rng(40)
    batch = 37
    for n in (1, 2, 3, 20, 32):
        for dtype in (torch.float32, torch.float64):
            code = int(dtype == torch.float64)
            k = torch.tensor(_spd(rng, batch, n, np.float64)).to(dtype)
            vec = torch.tensor(rng.standard_normal((batch, n))).to(dtype)
            if n == 20:
                k[5] = -k[5]
            k, vec = _offset(k), _offset(vec)
            want_low = bs.cholesky_plain(k)
            low = _offset(torch.full_like(k, float("nan")))
            assert lib.hamilton_spd_factor(code, 0, k.data_ptr(), low.data_ptr(), batch, n, 0,
                                           None) == 0
            assert _same(low, want_low), (n, dtype)
            want_x = bs.cho_solve_plain(want_low, vec)
            x = _offset(torch.full_like(vec, float("nan")))
            assert lib.hamilton_spd_substitute(code, want_low.data_ptr(), vec.data_ptr(),
                                               x.data_ptr(), batch, n, None) == 0
            assert _same(x, want_x), (n, dtype)
            nan = torch.isnan(x).any(-1)
            assert int(nan.sum()) == (1 if n == 20 else 0) and (n != 20 or bool(nan[5]))
            assert int(torch.isnan(low).flatten(1).any(-1).sum()) == (1 if n == 20 else 0)
