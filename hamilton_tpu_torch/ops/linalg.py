"""Small symmetric-positive-definite dense solves (the library path).

PyTorch counterpart of :mod:`hamilton_tpu.ops.linalg`.  ``K = JᵀMJ`` is SPD
by construction, so every ``K⁻¹`` application is a Cholesky solve,
dispatched on the shape as the reference dispatches it:

* n ≤ 2: the reference's closed forms;
* 3 ≤ n ≤ 32 with one or more batch axes and a vector right-hand side: the
  batched tiny-SPD entries of :mod:`~hamilton_tpu_torch.ops.batched_spd`
  (K2a–K2c), whose kernel runs on a CUDA tensor and whose plain version runs
  on a CPU tensor;
* anything else (n > 32, a matrix right-hand side, or an unbatched ``(n, n)``
  matrix, which is what code under ``torch.func.vmap`` sees): ``torch.linalg``,
  as the reference goes to XLA's Cholesky past ``SMALL_LIMIT``.
"""

from __future__ import annotations

import torch

from hamilton_tpu_torch.ops.batched_spd import (
    MAX_N,
    cho_solve_batched,
    cholesky_batched,
    spd_solve_batched,
)

__all__ = [
    "kernel_route",
    "spd_solve",
    "spd_cholesky",
    "cholesky_solve",
    "small_cholesky",
    "small_cho_solve",
]


def kernel_route(mat: torch.Tensor, b=None) -> bool:
    """Does a batched tiny-SPD entry take this call?  ``mat`` is K or L
    ``(..., n, n)``, or √M·J ``(..., m, n)``: one or more batch axes,
    ``3 ≤ n ≤ 32``, and (when ``b`` is given) a vector right-hand side."""
    n = mat.shape[-1]
    return (
        mat.ndim >= 3
        and 3 <= n <= MAX_N
        and (b is None or b.ndim == mat.ndim - 1)
    )


def spd_solve(k_mat: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``K x = b`` for SPD ``K`` of size ``(..., n, n)``; ``b`` may be
    ``(..., n)`` or ``(..., n, k)``."""
    n = k_mat.shape[-1]
    if n == 1:
        # keep the trailing length-1 axis so leading batch axes broadcast
        return b / k_mat[..., 0]
    if n == 2:
        a, c = k_mat[..., 0, 0], k_mat[..., 1, 1]
        bb = k_mat[..., 0, 1]
        det = a * c - bb * bb
        x0 = (c * b[..., 0] - bb * b[..., 1]) / det
        x1 = (a * b[..., 1] - bb * b[..., 0]) / det
        return torch.stack([x0, x1], dim=-1)
    if kernel_route(k_mat, b):
        return spd_solve_batched(k_mat, b)
    return cholesky_solve(spd_cholesky(k_mat), b)


def spd_cholesky(k_mat: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor of an SPD matrix.  ``cholesky_ex``
    does not read its error flag back to the host, so a CUDA caller never
    waits on the card (a matrix that is not SPD gives a meaningless factor
    instead of an exception, as in the reference)."""
    return torch.linalg.cholesky_ex(k_mat).L


def cholesky_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L Lᵀ x = b`` given the lower Cholesky factor ``L``."""
    vec = b.ndim == chol.ndim - 1
    if vec:
        b = b[..., None]
    x = torch.cholesky_solve(b, chol, upper=False)
    return x[..., 0] if vec else x


def small_cholesky(k_mat: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, a dense ``(..., n, n)`` tensor consumable by
    :func:`small_cho_solve` (the generalized-leapfrog factor cache)."""
    if kernel_route(k_mat):
        return cholesky_batched(k_mat)
    return spd_cholesky(k_mat)


def small_cho_solve(low: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L Lᵀ x = b`` for a :func:`small_cholesky` factor."""
    if kernel_route(low, b):
        return cho_solve_batched(low, b)
    return cholesky_solve(low, b)
