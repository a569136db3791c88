"""Small symmetric-positive-definite dense solves (the library path).

PyTorch counterpart of :mod:`hamilton_tpu.ops.linalg`.  ``K = JᵀMJ`` is SPD
by construction, so every ``K⁻¹`` application is a Cholesky solve.  The
n ≤ 2 closed forms are the reference's; everything larger goes to
``torch.linalg.cholesky`` / ``torch.cholesky_solve`` (the reference's
XLA:TPU size thresholds do not apply here).  The batched tiny-SPD kernels
the reference routes large f32 batches to (``ops/pallas_solve.py``) are not
ported yet (ROADMAP M10).
"""

from __future__ import annotations

import torch

__all__ = [
    "spd_solve",
    "spd_cholesky",
    "cholesky_solve",
    "small_cholesky",
    "small_cho_solve",
]


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
    return cholesky_solve(spd_cholesky(k_mat), b)


def spd_cholesky(k_mat: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor of an SPD matrix.  ``cholesky_ex``
    does not read its error flag back to the host, so the drift sampler on
    a CUDA device never waits on the card (a matrix that is not SPD gives a
    meaningless factor instead of an exception, as in the reference)."""
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
    return spd_cholesky(k_mat)


def small_cho_solve(low: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L Lᵀ x = b`` for a :func:`small_cholesky` factor."""
    return cholesky_solve(low, b)
