"""Carry state across from the JAX package as numpy arrays.

``System.params`` (masses, lengths, gravity, ``m1``/``m2``) and phases
exported from :mod:`hamilton_tpu` with ``np.asarray`` become the port's
tensors here, so both packages can be fed the same system and the same
initial conditions.  Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from hamilton_tpu_torch.state import Phase

__all__ = ["params_from_numpy", "phase_from_numpy"]


def _tensor(x, *, device, dtype) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.kind not in "fiu":
        raise TypeError(f"expected a real numeric array, got dtype {arr.dtype}")
    # a copy: arrays exported from JAX are read-only
    return torch.tensor(arr, device=device, dtype=dtype)


def params_from_numpy(
    params: Mapping[str, np.ndarray], *, device, dtype: torch.dtype
) -> Dict[str, torch.Tensor]:
    """``{name: array}`` → ``{name: tensor}`` on ``device`` in ``dtype``
    (hand the result to ``System.replace_params``).  Arrays may carry
    leading batch axes, e.g. ``(B, n)`` masses and ``(B,)`` gravity for a
    parameter sweep; every leaf then carries the same number of them."""
    return {k: _tensor(v, device=device, dtype=dtype) for k, v in params.items()}


def phase_from_numpy(q, p, *, device, dtype: torch.dtype) -> Phase:
    """Positions and momenta (numpy arrays of equal shape) → a :class:`Phase`
    on ``device`` in ``dtype``."""
    return Phase(_tensor(q, device=device, dtype=dtype),
                 _tensor(p, device=device, dtype=dtype))
