"""Batched tiny-SPD Cholesky factor and solves (the library path's kernels).

PyTorch counterpart of :mod:`hamilton_tpu.ops.pallas_solve`.  Every
right-hand-side evaluation of the library path solves ``K w = p`` with
``K = JᵀMJ`` of size n ≤ 32 for each ensemble member; these five entries do
it for a whole batch at once:

* :func:`spd_solve_batched` — factor K and solve (K2a, ``_solve_kernel``);
* :func:`cholesky_batched` — the lower factor L (K2b, ``_chol_kernel``);
* :func:`cho_solve_batched` — solve ``L Lᵀ x = b`` (K2c, ``_chosolve_kernel``);
* :func:`spd_solve_jac` — form ``K = (√M J)ᵀ(√M J)`` from :func:`jac_scaled`,
  factor and solve (K2d, ``_jac_solve_kernel``);
* :func:`cholesky_jac` — form K from √M·J and factor it (K2e,
  ``_jac_chol_kernel``).

Each takes any leading batch axes (flattened to one batch of any size, no
padding) and a vector right-hand side.  On a CUDA tensor it launches the
hand-written kernel of ``csrc/batched_spd.cu``; on a CPU tensor it runs the
plain PyTorch version beside it (``*_plain``), which computes the same IEEE
operations in the same order: the left-looking Cholesky of the reference's
``_chol_entries`` and the substitutions of its ``_solve_entries``.  A matrix
that is not SPD gives NaN in its member only.  bf16 is ROADMAP M10's
follow-up.  The reference's three layouts (member-major, batch-minor,
(8, 128) tiles) exist for TPU relayout costs; the port keeps the
member-major one.

Gradients: each entry is a ``torch.autograd.Function`` with the reference's
VJP.  The solves (K2a, K2c, K2d) call the same entry on the cotangent,
``gb = K⁻¹g`` — on a CUDA tensor that launches the kernel again — and form
the rank-1 terms (``gK = −gb xᵀ``, ``gL = tril((gK + gKᵀ)L)``, ``gJs =
Js(gK + gKᵀ)``) as plain tensor code; the factors (K2b, K2e) pull back
through the out-of-place masked Cholesky :func:`masked_cholesky` (the
reference's ``_masked_cholesky``), as the reference pulls back outside its
kernel.  Each composes with ``torch.func`` as with ``.backward()``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from hamilton_tpu_torch import kernels

__all__ = [
    "MAX_N",
    "spd_solve_batched",
    "cholesky_batched",
    "cho_solve_batched",
    "spd_solve_jac",
    "cholesky_jac",
    "jac_scaled",
    "masked_cholesky",
    "spd_solve_plain",
    "cholesky_plain",
    "cho_solve_plain",
    "spd_solve_jac_plain",
    "cholesky_jac_plain",
    "K2Entry",
    "ENTRIES",
]

#: The largest n the kernels take (the reference's ``SMALL_LIMIT``).
MAX_N = 32

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


# ----------------------------------------------------------------------
# The plain versions, on (B, ...) member-major tensors
# ----------------------------------------------------------------------


def _factor(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(L, 1/diag L)`` of K (B, n, n), column by column: entry (i, j) is
    ``K[i, j] − Σ_{k<j} L[i, k]·L[j, k]`` with the sum taken from k = 0, as
    in ``_chol_entries``."""
    n = k.shape[-1]
    low = torch.zeros_like(k)
    inv = torch.empty_like(k[:, 0])
    for j in range(n):
        s = k[:, j:, j]
        for c in range(j):
            s = s - low[:, j:, c] * low[:, j, c, None]
        d = torch.sqrt(s[:, 0])
        inv_d = torch.reciprocal(d)
        low[:, j, j] = d
        low[:, j + 1:, j] = s[:, 1:] * inv_d[:, None]
        inv[:, j] = inv_d
    return low, inv


def _substitute(low: torch.Tensor, inv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``L Lᵀ x = b`` as in ``_solve_entries``: each sum taken in increasing
    k.  The forward sweep updates the rows below i column by column, which
    takes the same terms in the same order."""
    n = b.shape[-1]
    v = b.clone()
    for i in range(n):
        v[:, i] = v[:, i] * inv[:, i]
        if i + 1 < n:
            v[:, i + 1:] = v[:, i + 1:] - low[:, i + 1:, i] * v[:, i, None]
    for i in reversed(range(n)):
        s = v[:, i]
        for c in range(i + 1, n):
            s = s - low[:, c, i] * v[:, c]
        v[:, i] = s * inv[:, i]
    return v


def _k_from_jac(js: torch.Tensor) -> torch.Tensor:
    """``K = (√M J)ᵀ(√M J)`` (B, n, n) from √M·J (B, m, n), the sum over m
    taken from row 0 as the kernel forms it (``_k_at_from_jac``)."""
    k = js[:, 0, :, None] * js[:, 0, None, :]
    for r in range(1, js.shape[1]):
        k = k + js[:, r, :, None] * js[:, r, None, :]
    return k


def masked_cholesky(k: torch.Tensor) -> torch.Tensor:
    """The lower factor of K ``(..., n, n)``, zeros above the diagonal, as the
    reference's ``_masked_cholesky`` (``hamilton_tpu/ops/linalg.py``) forms
    it: right-looking, a masked rank-1 update a column, out of place so that
    autograd differentiates it (the backwards of K2b and K2e pull back
    through it).  It reads K's lower triangle only."""
    n = k.shape[-1]
    idx = torch.arange(n, device=k.device)
    a = k
    for j in range(n):
        d = torch.sqrt(a[..., j, j])
        col = a[..., :, j] / d[..., None]
        l_col = torch.where(idx >= j, col, torch.zeros_like(col))
        below = idx > j
        upd = l_col[..., :, None] * l_col[..., None, :]
        keep = below[:, None] & below[None, :]
        a = a - torch.where(keep, upd, torch.zeros_like(upd))
        # column j of the factor, rows above j zeroed
        a = torch.where(idx == j, l_col[..., :, None], a)
    return a


def spd_solve_plain(k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K2a's plain version: K (B, n, n), b (B, n) → x."""
    return _substitute(*_factor(k), b)


def cholesky_plain(k: torch.Tensor) -> torch.Tensor:
    """K2b's plain version: the lower factor, zeros above the diagonal."""
    return _factor(k)[0]


def cho_solve_plain(low: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K2c's plain version: L (B, n, n), b (B, n) → x."""
    inv = torch.reciprocal(torch.diagonal(low, dim1=-2, dim2=-1))
    return _substitute(low, inv, b)


def spd_solve_jac_plain(js: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K2d's plain version: √M·J (B, m, n), b (B, n) → x."""
    return spd_solve_plain(_k_from_jac(js), b)


def cholesky_jac_plain(js: torch.Tensor) -> torch.Tensor:
    """K2e's plain version: √M·J (B, m, n) → L (B, n, n)."""
    return cholesky_plain(_k_from_jac(js))


# ----------------------------------------------------------------------
# The kernels' wrappers, on (B, ...) member-major CUDA tensors
# ----------------------------------------------------------------------


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _spd_solve_kernel(k, b):
    x = torch.empty_like(b)
    kernels.spd_solve_launch(dtype_code=_DTYPE_CODES[k.dtype], k=k.data_ptr(),
                             b=b.data_ptr(), x=x.data_ptr(), batch=k.shape[0],
                             n=k.shape[-1], stream=_stream(k))
    return x


def _cholesky_kernel(k):
    low = torch.empty_like(k)
    kernels.cholesky_launch(dtype_code=_DTYPE_CODES[k.dtype], k=k.data_ptr(),
                            low=low.data_ptr(), batch=k.shape[0], n=k.shape[-1],
                            stream=_stream(k))
    return low


def _cho_solve_kernel(low, b):
    x = torch.empty_like(b)
    kernels.cho_solve_launch(dtype_code=_DTYPE_CODES[low.dtype], low=low.data_ptr(),
                             b=b.data_ptr(), x=x.data_ptr(), batch=low.shape[0],
                             n=low.shape[-1], stream=_stream(low))
    return x


def _spd_solve_jac_kernel(js, b):
    x = torch.empty_like(b)
    kernels.spd_solve_jac_launch(dtype_code=_DTYPE_CODES[js.dtype], js=js.data_ptr(),
                                 b=b.data_ptr(), x=x.data_ptr(), batch=js.shape[0],
                                 n=js.shape[-1], m=js.shape[-2], stream=_stream(js))
    return x


def _cholesky_jac_kernel(js):
    n = js.shape[-1]
    low = js.new_empty((js.shape[0], n, n))
    kernels.cholesky_jac_launch(dtype_code=_DTYPE_CODES[js.dtype], js=js.data_ptr(),
                                low=low.data_ptr(), batch=js.shape[0], n=n,
                                m=js.shape[-2], stream=_stream(js))
    return low


# ----------------------------------------------------------------------
# The entries
# ----------------------------------------------------------------------

def _check(name: str, mats: torch.Tensor, vecs=None) -> None:
    dtype = mats.dtype
    if dtype == torch.bfloat16:
        raise NotImplementedError(
            f"{name}: bfloat16 is not ported yet (ROADMAP M10, K2 bf16)"
        )
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} takes float32 or float64, not {dtype}")
    if mats.ndim < 3:
        raise ValueError(
            f"{name} needs one or more batch axes, got shape {tuple(mats.shape)}"
        )
    n = mats.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name} takes 1 <= n <= {MAX_N}, got n={n}")
    if vecs is not None:
        if vecs.dtype != dtype or vecs.device != mats.device:
            raise ValueError(
                f"{name}: right-hand side {vecs.dtype} on {vecs.device} does not "
                f"match {dtype} on {mats.device}"
            )
        if vecs.ndim < 1 or vecs.shape[-1] != n:
            raise ValueError(
                f"{name}: right-hand side of shape {tuple(vecs.shape)} for n={n}"
            )


def _run(name: str, kernel: Callable, plain: Callable, mats, vecs=None):
    """Flatten the batch axes, run the kernel (CUDA) or the plain version
    (CPU), and restore them.  Returns ``(result, batch_shape)``."""
    tail = mats.shape[-2:]
    if vecs is None:
        batch = mats.shape[:-2]
        args = (mats.reshape(-1, *tail).contiguous(),)
    else:
        batch = torch.broadcast_shapes(mats.shape[:-2], vecs.shape[:-1])
        args = (mats.expand(*batch, *tail).reshape(-1, *tail).contiguous(),
                vecs.expand(*batch, vecs.shape[-1]).reshape(-1, vecs.shape[-1]).contiguous())
    device = mats.device
    if args[0].shape[0] == 0:
        out = plain(*args)
    elif device.type == "cuda":
        with torch.cuda.device(device):
            out = kernel(*args)
    elif device.type == "cpu":
        out = plain(*args)
    else:
        raise ValueError(f"{name}: no kernel and no plain version for device {device}")
    return out.reshape(*batch, *out.shape[1:])


def _outer(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return u[..., :, None] * v[..., None, :]


class _SpdSolve(torch.autograd.Function):
    @staticmethod
    def forward(k_mat, b):
        return _run("spd_solve_batched", _spd_solve_kernel, spd_solve_plain, k_mat, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)
        ctx.shapes = tuple(x.shape for x in inputs)

    @staticmethod
    def backward(ctx, g):
        # x = K⁻¹b:  gb = K⁻¹g (the kernel again),  gK = −gb xᵀ
        k_mat, x = ctx.saved_tensors
        gb = _SpdSolve.apply(k_mat, g)
        gk = -_outer(gb, x)
        return gk.sum_to_size(ctx.shapes[0]), gb.sum_to_size(ctx.shapes[1])


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(k_mat):
        return _run("cholesky_batched", _cholesky_kernel, cholesky_plain, k_mat)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g_low):
        # the pullback of the masked factorization, outside the kernel
        (k_mat,) = ctx.saved_tensors
        _, pullback = torch.func.vjp(masked_cholesky, k_mat)
        return pullback(g_low)[0]


class _ChoSolve(torch.autograd.Function):
    @staticmethod
    def forward(low, b):
        return _run("cho_solve_batched", _cho_solve_kernel, cho_solve_plain, low, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)
        ctx.shapes = tuple(x.shape for x in inputs)

    @staticmethod
    def backward(ctx, g):
        # x = K⁻¹b, K = LLᵀ:  gb = K⁻¹g (the kernel again),  gK = −gb xᵀ,
        # gL = tril((gK + gKᵀ)L)
        low, x = ctx.saved_tensors
        gb = _ChoSolve.apply(low, g)
        gk = -_outer(gb, x)
        gl = torch.tril((gk + gk.mT) @ low)
        return gl.sum_to_size(ctx.shapes[0]), gb.sum_to_size(ctx.shapes[1])


class _SpdSolveJac(torch.autograd.Function):
    @staticmethod
    def forward(js, b):
        return _run("spd_solve_jac", _spd_solve_jac_kernel, spd_solve_jac_plain, js, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)
        ctx.shapes = tuple(x.shape for x in inputs)

    @staticmethod
    def backward(ctx, g):
        # x = K⁻¹b, K = JsᵀJs:  gb = K⁻¹g (the kernel again),
        # gJs = Js(gK + gKᵀ) = −Js(gb xᵀ + x gbᵀ)
        js, x = ctx.saved_tensors
        gb = _SpdSolveJac.apply(js, g)
        gjs = -(js @ (_outer(gb, x) + _outer(x, gb)))
        return gjs.sum_to_size(ctx.shapes[0]), gb.sum_to_size(ctx.shapes[1])


class _CholeskyJac(torch.autograd.Function):
    @staticmethod
    def forward(js):
        return _run("cholesky_jac", _cholesky_jac_kernel, cholesky_jac_plain, js)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    @staticmethod
    def backward(ctx, g_low):
        # gK by the masked factorization's pullback, then gJs = Js(gK + gKᵀ)
        (js,) = ctx.saved_tensors
        _, pullback = torch.func.vjp(masked_cholesky, js.mT @ js)
        (gk,) = pullback(g_low)
        return js @ (gk + gk.mT)


def spd_solve_batched(k_mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x = K⁻¹ b`` for SPD K ``(..., n, n)`` and b ``(..., n)`` (K2a)."""
    _check("spd_solve_batched", k_mat, b)
    return _SpdSolve.apply(k_mat, b)


def cholesky_batched(k_mat: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor ``(..., n, n)`` of SPD K, zeros above the
    diagonal (K2b)."""
    _check("cholesky_batched", k_mat)
    return _Cholesky.apply(k_mat)


def cho_solve_batched(low: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L Lᵀ x = b`` for a :func:`cholesky_batched` factor (K2c)."""
    _check("cho_solve_batched", low, b)
    return _ChoSolve.apply(low, b)


def spd_solve_jac(js: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x = ((√M J)ᵀ(√M J))⁻¹ b`` from √M·J ``(..., m, n)`` (K2d): K is
    formed inside the kernel and never stored."""
    _check("spd_solve_jac", js, b)
    return _SpdSolveJac.apply(js, b)


def cholesky_jac(js: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor ``(..., n, n)`` of ``(√M J)ᵀ(√M J)`` (K2e)."""
    _check("cholesky_jac", js)
    return _CholeskyJac.apply(js)


def jac_scaled(j: torch.Tensor, inertia: torch.Tensor) -> torch.Tensor:
    """``√M·J`` ``(..., m, n)`` from J and the inertia vector ``(m,)``: the
    inertia folded in as a row scaling, so ``K = JᵀMJ = (√M J)ᵀ(√M J)``
    (counterpart of ``jac_tiles``)."""
    return torch.sqrt(inertia)[..., :, None].to(j.dtype) * j


@dataclass(frozen=True)
class K2Entry:
    """One K2 entry with its kernel wrapper, plain version, launch function
    (whose ``.launches`` counts it) and the TPU kernel it replaces."""

    name: str
    entry: Callable
    kernel: Callable
    plain: Callable
    launch: Callable
    replaces: str
    from_jac: bool
    solves: bool


_PALLAS = "hamilton_tpu/ops/pallas_solve.py"

#: The five entries in K2a..K2e order.
ENTRIES = (
    K2Entry("spd_solve_batched", spd_solve_batched, _spd_solve_kernel, spd_solve_plain,
            kernels.spd_solve_launch, f"{_PALLAS}:117", False, True),
    K2Entry("cholesky_batched", cholesky_batched, _cholesky_kernel, cholesky_plain,
            kernels.cholesky_launch, f"{_PALLAS}:124", False, False),
    K2Entry("cho_solve_batched", cho_solve_batched, _cho_solve_kernel, cho_solve_plain,
            kernels.cho_solve_launch, f"{_PALLAS}:131", False, True),
    K2Entry("spd_solve_jac", spd_solve_jac, _spd_solve_jac_kernel, spd_solve_jac_plain,
            kernels.spd_solve_jac_launch, f"{_PALLAS}:316", True, True),
    K2Entry("cholesky_jac", cholesky_jac, _cholesky_jac_kernel, cholesky_jac_plain,
            kernels.cholesky_jac_launch, f"{_PALLAS}:323", True, False),
)
