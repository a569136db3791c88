"""N-link pendulum chain (counterpart of :mod:`hamilton_tpu.models.chain`).

``System (2N, N)``: the Cartesian position of bob ``i`` is the cumulative
sum of the link vectors, so the coordinate map is a pair of ``cumsum``s
with closed-form Jacobian and mass matrix.  Masses, lengths and gravity live
in ``System.params``; the inertia vector is derived from the masses.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from hamilton_tpu_torch.models.base import Example
from hamilton_tpu_torch.state import Config
from hamilton_tpu_torch.system import mk_system_cart

__all__ = ["chain"]


def chain(
    n_links: int = 20,
    masses: Optional[Sequence[float]] = None,
    link_length: float = 1.0,
    gravity: float = 5.0,
    theta0: float = 0.5,
    fused_solver: str = "dense",
    *,
    device,
    dtype: torch.dtype,
) -> Example:
    """Chain of ``n_links`` pendulum links: bob ``i`` at
    ``x_i = Σ_{j≤i} l_j·sin θ_j``, ``y_i = Σ_{j≤i} l_j·(1 − cos θ_j)``,
    potential ``U = g·Σ_i m_i·y_i``; every link displaced by ``theta0``, at
    rest.

    ``fused_solver`` picks the fused kernel's linear algebra: ``"dense"``
    (in-register Cholesky), ``"semiseparable"`` (the exact O(n)
    factorization), ``"mobius"`` (that factorization with its recursion
    collapsed to a scalar Möbius chain) or ``"linv"`` (it plus the explicit
    inverse factor, so each solve is two mat-vecs).  A parameter sweep
    replaces the params with batched ones (``System.replace_params``:
    ``(B, n)`` masses and lengths, ``(B,)`` gravity); ``fused_forms`` then
    gives per-member coefficient tables (``(l, S, g·l·S)``, 3n entries a
    member, for the semiseparable and L⁻¹ families; Möbius adds ``m`` and
    ``1/m``).  Params that need a gradient give a shared run-time table.
    """
    from hamilton_tpu_torch.ops.fused_step import (
        serial_chain_forms, serial_chain_forms_linv, serial_chain_forms_mobius,
        serial_chain_forms_on,
    )

    factories = {
        "dense": serial_chain_forms,
        "semiseparable": serial_chain_forms_on,
        "mobius": serial_chain_forms_mobius,
        "linv": serial_chain_forms_linv,
    }
    if fused_solver not in factories:
        raise ValueError(
            f"fused_solver must be one of {sorted(factories)}, got {fused_solver!r}"
        )
    forms_factory = factories[fused_solver]

    if masses is None:
        masses = [1.0] * n_links
    masses = torch.as_tensor(masses, device=device, dtype=dtype)
    if masses.shape != (n_links,):
        raise ValueError(f"need {n_links} masses, got shape {tuple(masses.shape)}")
    params = {
        "masses": masses,
        "lengths": torch.full((n_links,), link_length, device=device, dtype=dtype),
        "gravity": torch.as_tensor(gravity, device=device, dtype=dtype),
    }

    # Cartesian layout is (x1..xN, y1..yN), as in the reference
    def inertia_fn(p):
        return torch.cat([p["masses"], p["masses"]])

    def coords(q, p):
        ls = p["lengths"].to(q.dtype)
        x = torch.cumsum(ls * torch.sin(q), 0)
        y = torch.cumsum(ls * (1.0 - torch.cos(q)), 0)
        return torch.cat([x, y])

    # closed-form Jacobian of the cumsum map: ∂x_i/∂θ_j = l_j·cosθ_j·[j ≤ i],
    # ∂y_i/∂θ_j = l_j·sinθ_j·[j ≤ i]
    tril = torch.tril(
        torch.ones((n_links, n_links), device=device, dtype=torch.bool)
    )

    def jacobian_fn(q, p):
        ls = p["lengths"].to(q.dtype)
        zero = torch.zeros((), device=q.device, dtype=q.dtype)
        jx = torch.where(tril, (ls * torch.cos(q))[None, :], zero)
        jy = torch.where(tril, (ls * torch.sin(q))[None, :], zero)
        return torch.cat([jx, jy], dim=0)  # (2N, N)

    # closed-form mass matrix K_ij = l_i·l_j·cos(θ_i−θ_j)·S_max(i,j) with the
    # suffix mass sums S_r = Σ_{k≥r} m_k
    def mass_matrix_fn(q, p):
        ms = p["masses"].to(q.dtype)
        ls = p["lengths"].to(q.dtype)
        suffix = torch.flip(torch.cumsum(torch.flip(ms, (0,)), 0), (0,))
        s_pair = torch.minimum(suffix[:, None], suffix[None, :])
        ll = ls[:, None] * ls[None, :]
        return ll * torch.cos(q[:, None] - q[None, :]) * s_pair

    def potential_cart(xs, p):
        ms = p["masses"].to(xs.dtype)
        g = p["gravity"].to(xs.dtype)
        return g * torch.sum(ms * xs[n_links:])

    def fused_forms(system):
        p = system.params
        return forms_factory(p["masses"], p["lengths"], p["gravity"])

    system = mk_system_cart(
        None, coords, potential_cart, device=device, dtype=dtype, n=n_links,
        name=f"chain{n_links}", jacobian_fn=jacobian_fn,
        mass_matrix_fn=mass_matrix_fn, fused_forms=fused_forms,
        params=params, inertia_fn=inertia_fn,
    )

    def draw(xs):
        return [torch.stack([xs[i], xs[n_links + i]]) for i in range(n_links)]

    return Example(
        name=f"{n_links}-link chain",
        coord_names=tuple(f"θ{i+1}" for i in range(n_links)),
        system=system,
        draw=draw,
        init_config=Config(
            torch.full((n_links,), theta0, device=device, dtype=dtype),
            torch.zeros((n_links,), device=device, dtype=dtype),
        ),
    )
