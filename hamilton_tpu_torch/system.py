"""System construction via automatic differentiation.

PyTorch counterpart of :mod:`hamilton_tpu.system`.  A :class:`System` holds
the inertia vector (or an ``inertia_fn`` deriving it from ``params``), the
physics parameters as a dict of tensors, and the user's pure functions; the
Jacobian, the rank-3 Hessian and the potential gradient are ``torch.func``
transforms (``jacfwd``/``grad``) applied on demand.

User-function contract: ``coords`` and ``potential`` are pure functions of
one member's ``(n,)`` tensor (plus ``params`` when given), written with
torch operations only and no Python branching on tensor values, so that
``torch.func.vmap`` maps them over ensemble batch axes.

Parameter sweeps: ``params`` leaves may carry extra leading batch axes
(:meth:`System.replace_params`); :func:`map_member` pairs them with the
trailing batch axes of the state, so an ensemble ``(B, n)`` evolves under
``(B, ...)``-batched params member by member.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.func import grad, jacfwd, vmap

__all__ = ["System", "mk_system", "mk_system_cart", "underlying_pos"]

Params = Dict[str, torch.Tensor]


def _as_params(params, *, device, dtype) -> Optional[Params]:
    if params is None:
        return None
    return {
        k: torch.as_tensor(v, device=device, dtype=dtype)
        for k, v in params.items()
    }


class System:
    """A physical system with ``n`` generalized coordinates embedded in an
    ``m``-dimensional Cartesian space (counterpart of
    :class:`hamilton_tpu.system.System`).

    ``device`` and ``dtype`` place the inertia vector and every ``params``
    tensor; :meth:`to` makes a converted copy (e.g. the float64 system the
    drift sampler measures with).
    """

    def __init__(
        self,
        inertia,
        coords: Callable[..., torch.Tensor],
        potential: Callable[..., torch.Tensor],
        *,
        device,
        dtype: torch.dtype,
        n: Optional[int] = None,
        name: str = "system",
        jacobian_fn: Optional[Callable[..., torch.Tensor]] = None,
        mass_matrix_fn: Optional[Callable[..., torch.Tensor]] = None,
        params=None,
        inertia_fn: Optional[Callable[[Params], torch.Tensor]] = None,
        fused_forms: Optional[Callable[["System"], object]] = None,
    ):
        if inertia_fn is not None:
            if params is None:
                raise ValueError("inertia_fn requires params")
            if inertia is not None:
                raise ValueError(
                    "give either a concrete inertia vector or inertia_fn "
                    "(derived from params), not both"
                )
            self._inertia = None
        else:
            if inertia is None:
                raise ValueError(
                    "inertia is required: give a concrete per-Cartesian-"
                    "coordinate mass vector, or derive it from params via "
                    "inertia_fn"
                )
            self._inertia = torch.as_tensor(inertia, device=device, dtype=dtype)
            if self._inertia.ndim != 1:
                raise ValueError(
                    f"inertia must be a rank-1 vector of per-Cartesian-"
                    f"coordinate masses, got shape {tuple(self._inertia.shape)}"
                )
        self.params = _as_params(params, device=device, dtype=dtype)
        # each leaf's construction-time rank: extra leading axes added later
        # (replace_params) are params batch axes
        self._params_ndim = (
            None if self.params is None
            else {k: v.ndim for k, v in self.params.items()}
        )
        self.device = torch.device(device)
        self.dtype = dtype
        self.inertia_fn = inertia_fn
        self.coords = coords
        self.potential = potential
        self._n = n
        self.name = name
        self.jacobian_fn = jacobian_fn
        self.mass_matrix_fn = mass_matrix_fn
        # ``fused_forms(system) -> ops.fused_step.FusedForms``: the closed-form
        # family contract that ``method="leapfrog_fused"`` builds its stepper
        # from, called with the live system so it reads the current params
        self.fused_forms = fused_forms

    # -- params plumbing ------------------------------------------------
    @property
    def has_params(self) -> bool:
        return self.params is not None

    def param_batch_ndim(self) -> int:
        """Number of extra leading batch axes the ``params`` leaves carry
        relative to their construction-time ranks (0 for unbatched).  All
        leaves must agree."""
        if self.params is None:
            return 0
        pbs = {v.ndim - self._params_ndim[k] for k, v in self.params.items()}
        if len(pbs) != 1:
            raise ValueError(
                f"inconsistent params batching: leaf batch ndims {sorted(pbs)} "
                f"(every params leaf must carry the same number of extra "
                f"leading axes)"
            )
        (pb,) = pbs
        if pb < 0:
            raise ValueError(
                "params leaves have fewer axes than at construction: params "
                "edits must keep each leaf's base shape"
            )
        return pb

    def _member_params(self, params):
        """The params of a single-member call: an explicit member ``params``
        wins; otherwise ``self.params``, which must then be unbatched."""
        if params is not None:
            return params
        if self.params is not None and self.param_batch_ndim() > 0:
            raise ValueError(
                "this System carries batched params; member-level calls "
                "(System.jacobian / potential_grad / ...) need explicit member "
                "params: use the batch-aware functions in "
                "hamilton_tpu_torch.mechanics instead"
            )
        return self.params

    def inertia_of(self, params=None) -> torch.Tensor:
        """The single-member inertia vector ``(m,)`` for the given member
        params (or this system's own, when unbatched)."""
        if self.inertia_fn is None:
            return self._inertia
        return self.inertia_fn(self._member_params(params))

    @property
    def inertia(self) -> torch.Tensor:
        """The inertia vector: the stored tensor, or ``inertia_fn(params)``
        with any params batch axes leading."""
        if self.inertia_fn is None:
            return self._inertia
        fn = self.inertia_fn
        for _ in range(self.param_batch_ndim()):
            fn = vmap(fn)
        return fn(self.params)

    def to(self, *, device=None, dtype: Optional[torch.dtype] = None) -> "System":
        """A copy with the inertia and params moved to ``device``/``dtype``
        (the functions are shared)."""
        device = self.device if device is None else device
        dtype = self.dtype if dtype is None else dtype
        new = object.__new__(System)
        new.__dict__.update(self.__dict__)
        new.device, new.dtype = torch.device(device), dtype
        if self._inertia is not None:
            new._inertia = self._inertia.to(device=device, dtype=dtype)
        new.params = _as_params(self.params, device=device, dtype=dtype)
        return new

    def replace_params(self, params) -> "System":
        """A copy with new ``params`` of the same keys (carried over from
        another source, e.g. :func:`convert.params_from_numpy`).  Each leaf
        keeps its construction-time shape as its trailing axes and may carry
        extra leading batch axes, the same number on every leaf: the
        parameter-sweep entry point."""
        if self.params is None:
            raise ValueError(f"system {self.name!r} carries no params")
        new_params = _as_params(params, device=self.device, dtype=self.dtype)
        if set(new_params) != set(self.params):
            raise ValueError(
                f"replace_params: keys {sorted(new_params)} do not match the "
                f"system's {sorted(self.params)}"
            )
        for k, v in new_params.items():
            base = self._params_ndim[k]
            want = tuple(self.params[k].shape[self.params[k].ndim - base:])
            got = tuple(v.shape[v.ndim - base:]) if v.ndim >= base else tuple(v.shape)
            if v.ndim < base or got != want:
                raise ValueError(
                    f"replace_params: {k!r} has shape {tuple(v.shape)}; it must "
                    f"end in the system's {want} (batch axes lead)"
                )
        new = self.to()
        new.params = new_params
        new.param_batch_ndim()  # validate the leaves' batching now
        return new

    # -- dimensions -----------------------------------------------------
    @property
    def m(self) -> int:
        """Cartesian (underlying) dimension."""
        return self.inertia.shape[-1]

    @property
    def n(self) -> Optional[int]:
        """Generalized-coordinate dimension, if declared at construction."""
        return self._n

    # -- member-level closures (params bound) ---------------------------
    def coords_bound(self, params=None) -> Callable[[torch.Tensor], torch.Tensor]:
        """``coords`` as a one-argument closure with member params bound."""
        if self.params is None:
            return self.coords
        p = self._member_params(params)
        return lambda q: self.coords(q, p)

    def potential_bound(self, params=None) -> Callable[[torch.Tensor], torch.Tensor]:
        """``potential`` as a one-argument closure with member params bound."""
        if self.params is None:
            return self.potential
        p = self._member_params(params)
        return lambda q: self.potential(q, p)

    # -- AD-derived closures ----------------------------------------------
    def jacobian(self, q: torch.Tensor, params=None) -> torch.Tensor:
        """``J(q) = df/dq``, shape ``(m, n)``: the analytic ``jacobian_fn``
        when given, else forward-mode AD of ``coords``."""
        if self.jacobian_fn is not None:
            if self.params is None:
                return self.jacobian_fn(q)
            return self.jacobian_fn(q, self._member_params(params))
        # in q's dtype, as jax.jacfwd returns it: torch.func.jacfwd promotes
        # a float32 map that divides a 0-d value by a Python float to float64
        return jacfwd(self.coords_bound(params))(q).to(q.dtype)

    def hessian(self, q: torch.Tensor, params=None) -> torch.Tensor:
        """Rank-3 ``d²f/dq²``, shape ``(m, n, n)``, in q's dtype."""
        return jacfwd(jacfwd(self.coords_bound(params)))(q).to(q.dtype)

    def potential_value(self, q: torch.Tensor, params=None) -> torch.Tensor:
        """``U(q)`` as a 0-d tensor."""
        return torch.as_tensor(self.potential_bound(params)(q)).reshape(())

    def potential_grad(self, q: torch.Tensor, params=None) -> torch.Tensor:
        """``∇U(q)``, shape ``(n,)``."""
        fn = self.potential_bound(params)
        return grad(lambda qq: fn(qq).reshape(()))(q)

    def underlying_pos(self, q: torch.Tensor, params=None) -> torch.Tensor:
        """``f(q)``: generalized → Cartesian positions."""
        return self.coords_bound(params)(q)

    def __repr__(self) -> str:
        return f"System(name={self.name!r}, m={self.m}, n={self._n})"


def map_member(system: System, fn, *args):
    """Map a member-level ``fn(*member_args, params)`` over the leading batch
    axes of ``args`` (each ``(..., n)``-shaped, batch shapes equal) with
    ``torch.func.vmap``.

    When the ``params`` leaves carry ``pb`` batch axes
    (:meth:`System.param_batch_ndim`), those pair with the **trailing** ``pb``
    batch axes of the state: an ensemble ``(B, n)`` maps member-wise with
    ``(B, ...)``-batched params, while extra leading state axes (time,
    stages) map with the params held fixed.  Unbatched params are shared by
    every member; a system without params hands ``fn`` None."""
    nd = args[0].ndim - 1
    pb = system.param_batch_ndim()
    if pb > nd:
        raise ValueError(
            f"params carry {pb} batch axes but the state has only {nd}; "
            f"batched params align with the trailing state batch axes "
            f"(state {tuple(args[0].shape)})"
        )
    if pb:
        lead = args[0].shape[nd - pb:nd]
        for k, v in system.params.items():
            if tuple(v.shape[:pb]) != tuple(lead):
                raise ValueError(
                    f"params batch {tuple(v.shape[:pb])} of {k!r} does not "
                    f"equal the state's trailing batch axes {tuple(lead)} "
                    f"(broadcast size-1 axes explicitly)"
                )

    def g(params, *a):
        return fn(*a, params)

    for _ in range(pb):  # innermost: member axes, params mapped jointly
        g = vmap(g)
    for _ in range(nd - pb):  # outer axes: params held fixed
        g = vmap(g, in_dims=(None,) + (0,) * len(args))
    return g(system.params, *args)


def mk_system(
    inertia,
    coords: Callable[..., torch.Tensor],
    potential: Callable[..., torch.Tensor],
    *,
    device,
    dtype: torch.dtype,
    n: Optional[int] = None,
    name: str = "system",
    jacobian_fn=None,
    mass_matrix_fn=None,
    params=None,
    inertia_fn=None,
    fused_forms=None,
) -> System:
    """Create a system from generalized-coordinate data (counterpart of
    :func:`hamilton_tpu.system.mk_system`); with ``n`` given, the user
    functions are shape-checked at construction."""
    system = System(
        inertia, coords, potential, device=device, dtype=dtype, n=n,
        name=name, jacobian_fn=jacobian_fn, mass_matrix_fn=mass_matrix_fn,
        params=params, inertia_fn=inertia_fn, fused_forms=fused_forms,
    )
    if n is not None:
        _validate_system(system, n)
    return system


def _validate_system(system: System, n: int) -> None:
    """Shape-check the user functions on a zero ``(n,)`` probe — the
    counterpart of the reference's ``jax.eval_shape`` checks (the probe is
    one tiny member, so evaluating it costs nothing)."""
    if system.inertia_fn is not None:
        try:
            i_out = system.inertia_fn(system.params)
        except Exception as e:
            raise ValueError(f"inertia_fn failed on the params: {e}") from e
        if i_out.ndim != 1:
            raise ValueError(
                f"inertia_fn must return a rank-1 (m,) vector, got shape "
                f"{tuple(i_out.shape)}"
            )
    probe = torch.zeros(n, device=system.device, dtype=system.dtype)

    def shape_of(fn, *args):
        if system.has_params:
            return tuple(torch.as_tensor(fn(*args, system.params)).shape)
        return tuple(torch.as_tensor(fn(*args)).shape)

    checks = [
        ("coords function", system.coords, (system.m,)),
        ("potential function", system.potential, None),
        ("jacobian_fn", system.jacobian_fn, (system.m, n)),
        ("mass_matrix_fn", system.mass_matrix_fn, (n, n)),
    ]
    for label, fn, want in checks:
        if fn is None:
            continue
        try:
            got = shape_of(fn, probe)
        except Exception as e:
            raise ValueError(f"{label} failed on a ({n},) input: {e}") from e
        if want is None:
            if got not in ((), (1,)):
                raise ValueError(f"potential must return a scalar, got shape {got}")
        elif got != want:
            raise ValueError(
                f"{label} must map ({n},) -> {want}, got output shape {got}"
            )


def mk_system_cart(
    inertia,
    coords: Callable[..., torch.Tensor],
    potential_cart: Callable[..., torch.Tensor],
    *,
    device,
    dtype: torch.dtype,
    n: Optional[int] = None,
    name: str = "system",
    jacobian_fn=None,
    mass_matrix_fn=None,
    params=None,
    inertia_fn=None,
    fused_forms=None,
) -> System:
    """Create a system with the potential stated in *Cartesian* coordinates
    (counterpart of :func:`hamilton_tpu.system.mk_system_cart`)."""
    if params is not None:
        def potential(q, p):
            return potential_cart(coords(q, p), p)
    else:
        def potential(q):
            return potential_cart(coords(q))
    return mk_system(
        inertia, coords, potential, device=device, dtype=dtype, n=n,
        name=name, jacobian_fn=jacobian_fn, mass_matrix_fn=mass_matrix_fn,
        params=params, inertia_fn=inertia_fn, fused_forms=fused_forms,
    )


def underlying_pos(system: System, q: torch.Tensor) -> torch.Tensor:
    """Generalized → underlying Cartesian positions, batched over any
    leading axes of ``q``."""
    return map_member(system, lambda qq, pp: system.underlying_pos(qq, pp), q)
