"""Adaptive embedded Runge-Kutta driver with GSL step-control semantics.

PyTorch counterpart of :mod:`hamilton_tpu.integrators.adaptive`: GSL's
adaptive RKF45 (``odeSolveV RKf45``, ``Numeric/Hamilton.hs:443-448``) with
its exact control laws:

* **error weighting** (gsl ``control/standard.c`` with a_y=1, a_dydt=0):
  ``D_i = eps_rel·|y_i| + eps_abs`` at the *updated* y, and
  ``rmax = max_i |yerr_i| / D_i``;
* **reject** if ``rmax > 1.1``: retry with ``h ← h·max(0.9·rmax^(−1/ord), 0.2)``,
  but only if that step is below ``*h`` and still advances t;
* **grow** if ``rmax < 0.5``: ``h ← h·clip(0.9·rmax^(−1/(ord+1)), 1, 5)``;
  otherwise keep ``h``;
* the final step of an interval is truncated to land exactly on ``t1``, and
  the next suggested ``h`` is adjusted from that truncated step.

The reference's ``lax.while_loop`` is an eager Python loop here.  The
controller state (t, h, the counters) stays on the state's device, and each
attempt reads one value back to the host: whether any controller is still
short of ``t1``.  ``gsl_evolve_to.host_reads`` counts those reads (set it to
0 before a run, read it after); an interval of ``k`` attempts makes ``k+1``.
Use float64 for GSL-level parity.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from hamilton_tpu_torch.integrators.tableaus import DOPRI5, RKCK, RKF45, Tableau

__all__ = ["ADAPTIVE_METHODS", "gsl_evolve_to", "embedded_rk_step", "GSL_EPS_DEFAULT"]

#: The reference's hard-coded tolerance (``Numeric/Hamilton.hs:448``).
GSL_EPS_DEFAULT = 1.49012e-08

ADAPTIVE_METHODS = {"rkf45": RKF45, "rkck": RKCK, "dopri5": DOPRI5}


def embedded_rk_step(
    rhs: Callable[[torch.Tensor], torch.Tensor], tab: Tableau
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """One explicit embedded-RK step: ``(y, h) -> (y_new, yerr)``; ``h``
    broadcasts against ``y`` (a scalar, or one step per member).

    The RHS is time-independent, as in the reference (``const f``,
    ``Numeric/Hamilton.hs:445``).
    """

    def step(y: torch.Tensor, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        ks = []
        for i in range(tab.stages):
            yi = y
            for j, aij in enumerate(tab.a[i]):
                if aij != 0.0:
                    yi = yi + (h * aij) * ks[j]
            ks.append(rhs(yi))
        y_new = y
        for bi, ki in zip(tab.b, ks):
            if bi != 0.0:
                y_new = y_new + (h * bi) * ki
        yerr = torch.zeros_like(y)
        for ei, ki in zip(tab.b_err, ks):
            if ei != 0.0:
                yerr = yerr + (h * ei) * ki
        return y_new, yerr

    return step


def gsl_evolve_to(
    rhs: Callable[[torch.Tensor], torch.Tensor],
    y0: torch.Tensor,
    t0,
    t1,
    h_suggest,
    *,
    eps_abs: float = GSL_EPS_DEFAULT,
    eps_rel: float = GSL_EPS_DEFAULT,
    method: str = "rkf45",
    max_steps: int = 1_000_000,
    return_stats: bool = False,
    per_member: bool = False,
):
    """Integrate ``y' = rhs(y)`` from ``t0`` to ``t1`` with GSL semantics.

    Returns ``(y(t1), h_suggest_next)`` — the suggested step is carried across
    output intervals exactly as ``gsl_odeiv2_driver_apply`` does.  Forward
    integration only (``t1 >= t0``), matching every reference use.

    ``per_member=True`` gives every member along ``y0``'s leading axes its
    own controller (the reference vmaps this driver for that): t, the steps
    and the counters become per-member tensors, the RHS is evaluated on the
    whole batch, and a member that has reached ``t1`` keeps its state while
    the others go on — the semantics of a vmapped ``while_loop``.

    ``return_stats=True`` appends a stats dict: ``n_steps`` / ``n_failed``
    attempt counters and ``saturated`` — True when the loop exhausted
    ``max_steps`` before reaching ``t1``, in which case the returned state
    is at ``t < t1``, NOT at the requested time.
    """
    tab = ADAPTIVE_METHODS[method]
    order = tab.order
    step = embedded_rk_step(rhs, tab)

    dtype, device = y0.dtype, y0.device
    cshape = y0.shape[:-1] if per_member else ()

    def scalar(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    t1 = scalar(t1)
    t = scalar(t0).expand(cshape)
    h_star = scalar(h_suggest).expand(cshape)
    h_try = h_star
    n_steps = torch.zeros(cshape, dtype=torch.int32, device=device)
    n_failed = torch.zeros(cshape, dtype=torch.int32, device=device)
    y = y0

    while True:
        active = torch.logical_and(t < t1, n_steps < max_steps)
        gsl_evolve_to.host_reads += 1
        if not bool(active.any()):
            break
        dt_rem = t1 - t
        final = h_try >= dt_rem
        h0 = torch.where(final, dt_rem, h_try)

        y_new, yerr = step(y, h0[..., None] if per_member else h0)

        d0 = eps_rel * torch.abs(y_new) + eps_abs
        ratio = torch.abs(yerr) / d0
        rmax = torch.amax(ratio, dim=-1) if per_member else torch.max(ratio)

        dec = rmax > 1.1
        inc = rmax < 0.5
        r_dec = torch.maximum(0.9 * rmax ** (-1.0 / order), scalar(0.2))
        r_inc = torch.clamp(0.9 * rmax ** (-1.0 / (order + 1.0)), 1.0, 5.0)
        h_dec = h0 * r_dec
        h_inc = h0 * r_inc

        # gsl evolve_apply: retry only if the step actually decreased vs *h
        # and would still advance time (underflow guard)
        retry = dec & (h_dec < h_star) & (t + h_dec > t)
        accept = torch.logical_not(retry)

        t_acc = torch.where(final, t1, t + h0)
        # next suggested step on accept:
        #   dec-but-not-retried -> keep *h; inc -> grown from h0; else -> h0
        h_star_acc = torch.where(dec, h_star, torch.where(inc, h_inc, h0))

        new = (
            torch.where(accept, t_acc, t),
            torch.where(accept[..., None] if per_member else accept, y_new, y),
            torch.where(accept, h_star_acc, h_star),
            torch.where(accept, h_star_acc, h_dec),
            n_failed + retry.to(torch.int32),
        )
        if per_member:
            # members already at t1 keep their carry, as under a vmapped loop
            new = tuple(
                torch.where(active[..., None] if v.ndim > active.ndim else active, v, old)
                for v, old in zip(new, (t, y, h_star, h_try, n_failed))
            )
        t, y, h_star, h_try, n_failed = new
        n_steps = n_steps + active.to(torch.int32)

    if return_stats:
        stats = {
            "n_steps": n_steps,
            "n_failed": n_failed,
            "saturated": torch.logical_and(n_steps >= max_steps, t < t1),
        }
        return y, h_star, stats
    return y, h_star


gsl_evolve_to.host_reads = 0
