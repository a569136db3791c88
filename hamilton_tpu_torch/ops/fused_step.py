"""Fused whole-step leapfrog: the closed-form family interface, its plain
PyTorch version, and the wrapper of the hand-written Hopper kernel.

PyTorch counterpart of ``hamilton_tpu/ops/pallas_step.py``.  A system family
whose physics admit *closed forms* states them once, as a
:class:`FusedForms` contract, against entry accessors ``at`` and a math
namespace ``fm`` (:data:`FM_TORCH`); the same family code then evaluates on
``(B,)`` member columns (the plain version, :func:`fused_step_reference`)
and, for the families compiled into it, runs inside the CUDA kernel
``csrc/fused_step.cu``, which computes the identical arithmetic in the same
order with one thread per member.

The state of a fused stepper is one contiguous tensor ``(n_sv, n, B)``
(batch-minor, so the kernel's loads and stores coalesce): ``q, p, a_est,
vdot_est`` — plus the Kahan residuals ``cq, cp`` after ``p`` when
``compensated`` (``n_sv`` is 4 or 6).  ``steps_per_call`` dt-steps run per
call; inside a call the end-of-step factor and aux ride to the next step
(step 0 is peeled and factorizes afresh — the factor never crosses calls).

A tensor on the CPU runs the plain version; a CUDA tensor launches the
kernel, or raises when no kernel is compiled for its family, size or
dtype.  Not ported yet (ROADMAP M9): per-member (swept) coefficient tables,
the Yoshida/Suzuki compositions, the ``linv``/``mobius`` chain solvers, the
other model families, and gradients through the fused step.
"""

from __future__ import annotations

import types
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from hamilton_tpu_torch import kernels
from hamilton_tpu_torch.integrators.fixed import Stepper, _iters_pair, _kahan_add
from hamilton_tpu_torch.state import Phase

__all__ = [
    "FusedForms",
    "FamilyFns",
    "FM_TORCH",
    "KERNEL_INSTANTIATIONS",
    "concrete_vec",
    "concrete_scalar",
    "coef_table",
    "serial_chain_forms",
    "serial_chain_forms_on",
    "fused_step",
    "fused_step_kernel",
    "fused_step_reference",
    "fused_stepper",
]


def _suffix_sums(xs):
    out, acc = [], 0.0
    for x in reversed(xs):
        acc += float(x)
        out.append(acc)
    return list(reversed(out))


def concrete_vec(x, n: int):
    """``x`` as a list of n Python floats when it is a plain sequence or an
    unbatched 1-D tensor that needs no gradient, else None (the per-member
    coefficient mode, ROADMAP M9)."""
    if isinstance(x, (list, tuple)):
        if len(x) != n:
            raise ValueError(f"expected {n} per-link values, got {len(x)}")
        return [float(v) for v in x]
    if isinstance(x, torch.Tensor) and x.ndim == 1 and not x.requires_grad:
        return [float(v) for v in x.tolist()]
    return None


def concrete_scalar(x):
    """``x`` as a Python float when concrete and unbatched, else None."""
    if isinstance(x, (int, float)):
        return float(x)
    if isinstance(x, torch.Tensor) and x.ndim == 0 and not x.requires_grad:
        return float(x.item())
    return None


def _fm_full(v, like):
    """A coefficient as a value in the arithmetic domain of ``like``: Python
    floats broadcast to ``like``'s shape, tensors pass through."""
    if isinstance(v, (int, float)):
        return torch.full_like(like, v)
    return v


#: The math namespace handed to ``FusedForms.make`` for the plain version:
#: families write their closed forms against ``fm.sin``/``cos``/``exp``/
#: ``sqrt``/``full``/``zero`` plus ``+ − * /`` (mirror of the reference's
#: ``FM_JNP``).
FM_TORCH = types.SimpleNamespace(
    sin=torch.sin,
    cos=torch.cos,
    exp=torch.exp,
    sqrt=torch.sqrt,
    full=_fm_full,
    zero=torch.zeros_like,
)


class FamilyFns(NamedTuple):
    """The closed forms of one system family on per-member values.

    All callables take and return per-member values (``(B,)`` columns in the
    plain version) and combine them only with ``+ − * /`` and the ``fm``
    namespace they were built against.

    ``aux(q)``: the auxiliary tuple (e.g. the sin/cos pairs) at ``q``.
    ``k_at(aux, q)``: entry accessor ``(i, j) → K_ij`` (``j ≤ i``).
    ``dhdq(aux, q, w)``: ``∂H/∂q_k = ∇U_k(q) − ∂T/∂q_k|_w``.
    ``potential(aux, q)``: optional ``U(q)``.
    ``factor_solve``: optional structure-exploiting ``(factor, solve)``
    pair replacing the dense Cholesky on ``k_at``.
    ``aux_shift(aux, dq)``: optional first-order aux at ``q + dq``, used for
    the within-step re-evaluations in float32 only.
    """

    aux: Callable[..., tuple]
    k_at: Callable[..., Callable[[int, int], Any]]
    dhdq: Callable[..., list]
    potential: Optional[Callable[..., Any]] = None
    factor_solve: Optional[Tuple[Callable[..., tuple], Callable[..., list]]] = None
    aux_shift: Optional[Callable[..., tuple]] = None


@dataclass(frozen=True)
class FusedForms:
    """A system family's contract with the fused whole-step step.

    ``n``: generalized degrees of freedom; ``n_aux``: length of the aux
    tuple; ``coef_lens``: flat length of each coefficient table;
    ``consts``: the tables as tuples of Python floats when every physical
    parameter is concrete and shared (None otherwise — per-member tables
    are ROADMAP M9); ``make(at, fm) → FamilyFns`` builds the closed forms
    against entry accessors ``at[t](i)`` and math namespace ``fm``;
    ``name`` names the family (and selects its compiled kernel).
    """

    n: int
    n_aux: int
    coef_lens: Tuple[int, ...]
    consts: Optional[Tuple[Tuple[float, ...], ...]]
    make: Callable[..., FamilyFns]
    name: str = "family"

    def const_accessors(self):
        """Entry accessors over the concrete tables."""
        return tuple(
            (lambda i, t=t: self.consts[t][i]) for t in range(len(self.coef_lens))
        )


def _chain_size(masses, lengths) -> int:
    n = len(masses) if isinstance(masses, (list, tuple)) else int(masses.shape[-1])
    n_len = len(lengths) if isinstance(lengths, (list, tuple)) else int(
        lengths.shape[-1]
    )
    if n_len != n:
        raise ValueError(f"need {n} lengths, got {n_len}")
    return n


def _trig_aux(fm):
    def aux(q):
        return tuple(fm.sin(qi) for qi in q) + tuple(fm.cos(qi) for qi in q)

    return aux


def _trig_aux_shift(n):
    """First-order rotation of an (n sin, n cos) aux tuple: ``s' = s+dq·c``,
    ``c' = c−dq·s`` — exact to ``dq²/2``."""

    def aux_shift(aux_v, dq):
        s, c = aux_v[:n], aux_v[n:]
        return tuple(s[i] + dq[i] * c[i] for i in range(n)) + tuple(
            c[i] - dq[i] * s[i] for i in range(n)
        )

    return aux_shift


def serial_chain_forms(masses, lengths, gravity) -> FusedForms:
    """:class:`FusedForms` for the planar serial linkage (pendulum, double
    pendulum, N-link chain) with the dense in-register Cholesky:

    * ``K_ij(q)   = l_i·l_j·cos(θ_i−θ_j)·S_max(i,j)``
    * ``∇U_i(q)   = g·l_i·sin(θ_i)·S_i``
    * ``∂T/∂θ_k|w = −l_k·w_k·Σ_j l_j·sin(θ_k−θ_j)·S_kj·w_j``
    * ``U(q)      = Σ_i g·l_i·S_i·(1 − cos θ_i)``

    with ``S_r = Σ_{k≥r} m_k``.  Tables: ``C_ij = l_i·l_j·S_max(i,j)`` (n²)
    and ``g·l_i·S_i`` (n).
    """
    n = _chain_size(masses, lengths)
    m_c = concrete_vec(masses, n)
    l_c = concrete_vec(lengths, n)
    g_c = concrete_scalar(gravity)
    consts = None
    if m_c is not None and l_c is not None and g_c is not None:
        suff = _suffix_sums(m_c)
        consts = (
            tuple(
                l_c[i] * l_c[j] * suff[max(i, j)]
                for i in range(n) for j in range(n)
            ),
            tuple(g_c * l_c[i] * suff[i] for i in range(n)),
        )

    def make(at, fm):
        cm = lambda i, j: at[0](i * n + j)  # noqa: E731
        gu_at = at[1]

        def k_at(aux_v, q):
            s, c = aux_v[:n], aux_v[n:]

            def at_(i, j):
                if i == j:
                    # cos(0)·C_ii exactly (not c²+s² with its rounding)
                    return fm.full(cm(i, i), s[0])
                return cm(i, j) * (c[i] * c[j] + s[i] * s[j])

            return at_

        def dhdq(aux_v, q, w):
            """∂H/∂q = ∇U − ∂T/∂q|_w in the 4n² dot-product form
            Σ_j C_kj·sin(θk−θj)·w_j = s_k·Σ_j C_kj·c_j·w_j − c_k·Σ_j C_kj·s_j·w_j
            (the j=k terms cancel in real arithmetic and are kept)."""
            s, c = aux_v[:n], aux_v[n:]
            cw = [c[j] * w[j] for j in range(n)]
            sw = [s[j] * w[j] for j in range(n)]
            out = []
            for k in range(n):
                acc_c = cm(k, 0) * cw[0]
                acc_s = cm(k, 0) * sw[0]
                for j in range(1, n):
                    acc_c = acc_c + cm(k, j) * cw[j]
                    acc_s = acc_s + cm(k, j) * sw[j]
                out.append(
                    gu_at(k) * s[k] + w[k] * (s[k] * acc_c - c[k] * acc_s)
                )
            return out

        def potential(aux_v, q):
            c = aux_v[n:]
            u = gu_at(0) * (1.0 - c[0])
            for i in range(1, n):
                u = u + gu_at(i) * (1.0 - c[i])
            return u

        return FamilyFns(_trig_aux(fm), k_at, dhdq, potential,
                         aux_shift=_trig_aux_shift(n))

    return FusedForms(
        n=n, n_aux=2 * n, coef_lens=(n * n, n), consts=consts, make=make,
        name="serial_chain",
    )


def serial_chain_forms_on(masses, lengths, gravity) -> FusedForms:
    """O(n) **semiseparable** variant of :func:`serial_chain_forms`.

    With link vectors ``u_i = l_i·(cosθ_i, sinθ_i)``, ``K_ij =
    S_max(i,j)·(u_i·u_j)`` is order-2 semiseparable, which admits an exact
    O(n) Cholesky (tip to base, with a 2×2 running state ``P``), O(n)
    triangular solves with 2-vector accumulators, and an O(n) ``∂H/∂q`` by
    prefix/suffix sums.  The factor is 5n values ``(z_x, z_y, 1/d, u_x,
    u_y)`` per member; the table is 3n entries ``(l_i, S_i, g·l_i·S_i)``.
    Same fixed points as the dense family.
    """
    n = _chain_size(masses, lengths)
    m_c = concrete_vec(masses, n)
    l_c = concrete_vec(lengths, n)
    g_c = concrete_scalar(gravity)
    consts = None
    if m_c is not None and l_c is not None and g_c is not None:
        suff = _suffix_sums(m_c)
        consts = (
            tuple(l_c) + tuple(suff)
            + tuple(g_c * l_c[i] * suff[i] for i in range(n)),
        )

    def make(at, fm):
        l_at = lambda i: at[0](i)            # noqa: E731  l_i
        s_at = lambda i: at[0](n + i)        # noqa: E731  S_i (suffix mass)
        gu_at = lambda i: at[0](2 * n + i)   # noqa: E731  g·l_i·S_i

        def k_at(aux_v, q):
            # dense-entry form (parity tests); the step uses factor_solve
            s, c = aux_v[:n], aux_v[n:]

            def at_(i, j):
                if i == j:
                    return fm.full(l_at(i) * l_at(i) * s_at(i), s[0])
                hi = max(i, j)
                return (l_at(i) * l_at(j) * s_at(hi)) * (
                    c[i] * c[j] + s[i] * s[j]
                )

            return at_

        def factor(aux_v, q):
            """Semiseparable Cholesky, tip to base: the flat entries
            (z_x, z_y, 1/d, u_x, u_y per link in processing order)."""
            s, c = aux_v[:n], aux_v[n:]
            zxs, zys, ids, uxs, uys = [], [], [], [], []
            pxx = pxy = pyy = None  # 2×2 running state, starts at zero
            for a in range(n):
                i = n - 1 - a
                ux = l_at(i) * c[i]
                uy = l_at(i) * s[i]
                si = s_at(i)
                if pxx is None:
                    yx = si * ux
                    yy = si * uy
                else:
                    yx = si * ux - (pxx * ux + pxy * uy)
                    yy = si * uy - (pxy * ux + pyy * uy)
                d = fm.sqrt(ux * yx + uy * yy)
                inv_d = 1.0 / d
                zx = yx * inv_d
                zy = yy * inv_d
                if pxx is None:
                    pxx, pxy, pyy = zx * zx, zx * zy, zy * zy
                else:
                    pxx = pxx + zx * zx
                    pxy = pxy + zx * zy
                    pyy = pyy + zy * zy
                zxs.append(zx)
                zys.append(zy)
                ids.append(inv_d)
                uxs.append(ux)
                uys.append(uy)
            return tuple(zxs + zys + ids + uxs + uys)

        def solve(ent, b):
            """O(n) ``L Lᵀ x = b``; ``b`` and the result in link order."""
            zx, zy = ent[0:n], ent[n:2 * n]
            idv = ent[2 * n:3 * n]
            ux, uy = ent[3 * n:4 * n], ent[4 * n:5 * n]
            y = [None] * n
            sx = sy = None
            for a in range(n):
                bi = b[n - 1 - a]
                t = bi if sx is None else bi - (ux[a] * sx + uy[a] * sy)
                ya = t * idv[a]
                y[a] = ya
                if sx is None:
                    sx, sy = zx[a] * ya, zy[a] * ya
                else:
                    sx = sx + zx[a] * ya
                    sy = sy + zy[a] * ya
            x = [None] * n
            tx = ty = None
            for a in reversed(range(n)):
                t = y[a] if tx is None else y[a] - (zx[a] * tx + zy[a] * ty)
                xa = t * idv[a]
                x[n - 1 - a] = xa
                if tx is None:
                    tx, ty = ux[a] * xa, uy[a] * xa
                else:
                    tx = tx + ux[a] * xa
                    ty = ty + uy[a] * xa
            return x

        def dhdq(aux_v, q, w):
            """O(n): ``∂H/∂θ_k = g·l_k·S_k·s_k + w_k·l_k·[s_k·A_k − c_k·B_k]``
            with ``A_k = S_k·Σ_{j<k} l_j c_j w_j + Σ_{j≥k} S_j l_j c_j w_j``
            (``B_k`` the sine analogue)."""
            s, c = aux_v[:n], aux_v[n:]
            lw = [l_at(j) * w[j] for j in range(n)]
            lcw = [lw[j] * c[j] for j in range(n)]
            lsw = [lw[j] * s[j] for j in range(n)]
            qc = [None] * n
            qs = [None] * n
            qc[n - 1] = s_at(n - 1) * lcw[n - 1]
            qs[n - 1] = s_at(n - 1) * lsw[n - 1]
            for k in range(n - 2, -1, -1):
                qc[k] = qc[k + 1] + s_at(k) * lcw[k]
                qs[k] = qs[k + 1] + s_at(k) * lsw[k]
            out = []
            pc = ps = None
            for k in range(n):
                if pc is None:
                    ak = qc[k]
                    bk = qs[k]
                else:
                    ak = s_at(k) * pc + qc[k]
                    bk = s_at(k) * ps + qs[k]
                out.append(
                    gu_at(k) * s[k] + w[k] * l_at(k) * (s[k] * ak - c[k] * bk)
                )
                if pc is None:
                    pc, ps = lcw[k], lsw[k]
                else:
                    pc = pc + lcw[k]
                    ps = ps + lsw[k]
            return out

        def potential(aux_v, q):
            c = aux_v[n:]
            u = gu_at(0) * (1.0 - c[0])
            for i in range(1, n):
                u = u + gu_at(i) * (1.0 - c[i])
            return u

        return FamilyFns(_trig_aux(fm), k_at, dhdq, potential, (factor, solve),
                         aux_shift=_trig_aux_shift(n))

    return FusedForms(
        n=n, n_aux=2 * n, coef_lens=(3 * n,), consts=consts, make=make,
        name="serial_chain_on",
    )


# ----------------------------------------------------------------------
# Dense in-register Cholesky on per-member entries
# (mirror of hamilton_tpu/ops/pallas_solve.py::_chol_entries/_solve_entries)
# ----------------------------------------------------------------------


def _chol_entries(k_at, n: int):
    """Unrolled Cholesky on per-member entries: the lower factor as a dict
    ``{(i, j): value}`` plus the reciprocal diagonal."""
    low = {}
    inv_diag = [None] * n
    for j in range(n):
        s = k_at(j, j)
        for k in range(j):
            ljk = low[(j, k)]
            s = s - ljk * ljk
        d = torch.sqrt(s)
        low[(j, j)] = d
        inv_d = 1.0 / d
        inv_diag[j] = inv_d
        for i in range(j + 1, n):
            s = k_at(i, j)
            for k in range(j):
                s = s - low[(i, k)] * low[(j, k)]
            low[(i, j)] = s * inv_d
    return low, inv_diag


def _solve_entries(low, inv_diag, b_at, n: int):
    """Unrolled ``L Lᵀ x = b`` on per-member entries."""
    y = [None] * n
    for i in range(n):
        s = b_at(i)
        for k in range(i):
            s = s - low[(i, k)] * y[k]
        y[i] = s * inv_diag[i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - low[(k, i)] * x[k]
        x[i] = s * inv_diag[i]
    return x


# ----------------------------------------------------------------------
# The plain version: the step on (B,) member columns
# ----------------------------------------------------------------------


def _factor_solve_fns(fam: FamilyFns, n: int):
    if fam.factor_solve is not None:
        return fam.factor_solve

    def factor_fn(aux_v, q):
        low, inv_d = _chol_entries(fam.k_at(aux_v, q), n)
        return tuple(
            low[(i, j)] for i in range(n) for j in range(i + 1)
        ) + tuple(inv_d)

    def solve_fn(ent, b):
        low, k = {}, 0
        for i in range(n):
            for j in range(i + 1):
                low[(i, j)] = ent[k]
                k += 1
        return _solve_entries(low, list(ent[k:]), lambda i: b[i], n)

    return factor_fn, solve_fn


def _make_increments(fam: FamilyFns, n: int, iters_p: int, iters_q: int):
    aux_fn, dhdq = fam.aux, fam.dhdq
    factor_fn, solve_fn = _factor_solve_fns(fam, n)

    def increments(q0, p0, a_est, vdot_est, dt, half, fac0=None):
        """Lists of per-member values → ``(dq_inc, dp_inc, b, vdot1, fac1)``.

        ``(a_est, vdot_est)`` warm-start the two fixed points from the
        previous step's converged force and velocity derivative.  ``fac0``,
        when given, is the previous step's end-of-step ``(factor, aux)``
        and replaces the q₀ factorization."""
        if fac0 is not None:
            ent0, aux0 = fac0
        else:
            aux0 = aux_fn(q0)
            ent0 = factor_fn(aux0, q0)
        ph = [p0[i] - half * a_est[i] for i in range(n)]
        a_last = a_est
        for _ in range(iters_p):
            w = solve_fn(ent0, ph)
            a_last = dhdq(aux0, q0, w)
            ph = [p0[i] - half * a_last[i] for i in range(n)]
        v0 = solve_fn(ent0, ph)
        q1 = [q0[i] + dt * v0[i] + (dt * half) * vdot_est[i]
              for i in range(n)]  # warm predictor
        v_last = v0
        # within-step aux re-evaluations by first-order shift: float32 only
        # (the dq²/2 truncation is below f32 resolution but visible in f64)
        shift = fam.aux_shift
        if shift is not None and q0[0].dtype != torch.float32:
            shift = None

        def aux_at(q_new, q_base, aux_base):
            if shift is None:
                return aux_fn(q_new)
            return shift(aux_base, [q_new[i] - q_base[i] for i in range(n)])

        if iters_q == 0:
            # predictor-factor placement: one factor at the O(dt²) predictor
            # serves the q-refinement and the end-of-step force
            aux1 = aux_fn(q1)
            ent1 = factor_fn(aux1, q1)
            v_last = solve_fn(ent1, ph)
            q1p, q1 = q1, [q0[i] + half * (v0[i] + v_last[i]) for i in range(n)]
            aux1r = aux_at(q1, q1p, aux1)
            b = dhdq(aux1r, q1, v_last)
            fac1 = (tuple(ent1), tuple(aux1r))
        else:
            q1p, aux1 = None, None
            for _ in range(iters_q):
                aux1 = aux_fn(q1) if aux1 is None else aux_at(q1, q1p, aux1)
                q1p = q1
                ent1 = factor_fn(aux1, q1)
                v_last = solve_fn(ent1, ph)
                q1 = [q0[i] + half * (v0[i] + v_last[i]) for i in range(n)]
            # exact end-of-step factor at the converged q1
            aux1 = aux_at(q1, q1p, aux1)
            ent1 = factor_fn(aux1, q1)
            w1 = solve_fn(ent1, ph)
            b = dhdq(aux1, q1, w1)
            fac1 = (tuple(ent1), tuple(aux1))
        dq_inc = [half * (v0[i] + v_last[i]) for i in range(n)]
        dp_inc = [-half * (a_last[i] + b[i]) for i in range(n)]
        inv_dt = 1.0 / dt
        vdot1 = [(v_last[i] - v0[i]) * inv_dt for i in range(n)]
        return dq_inc, dp_inc, b, vdot1, fac1

    return increments


def _build_step_once(increments, n: int, compensated: bool, dt, half):
    """One dt-step on per-member values, with or without Kahan-compensated
    accumulation."""
    if not compensated:

        def step_once(state, fac):
            qs, ps, avs, vds = state
            dq, dp, b, vd1, fac = increments(
                list(qs), list(ps), list(avs), list(vds), dt, half, fac0=fac
            )
            qs = tuple(qs[i] + dq[i] for i in range(n))
            ps = tuple(ps[i] + dp[i] for i in range(n))
            return (qs, ps, tuple(b), tuple(vd1)), fac

        return step_once

    def step_once(state, fac):
        qs, ps, cqs, cps, avs, vds = state
        dq, dp, b, vd1, fac = increments(
            list(qs), list(ps), list(avs), list(vds), dt, half, fac0=fac
        )
        q_c = [_kahan_add(qs[i], cqs[i], dq[i]) for i in range(n)]
        p_c = [_kahan_add(ps[i], cps[i], dp[i]) for i in range(n)]
        return (
            tuple(x for x, _ in q_c), tuple(x for x, _ in p_c),
            tuple(c for _, c in q_c), tuple(c for _, c in p_c),
            tuple(b), tuple(vd1),
        ), fac

    return step_once


def _check_state(forms: FusedForms, state: torch.Tensor, compensated: bool,
                 steps_per_call: int):
    n_sv = 6 if compensated else 4
    if state.ndim != 3 or tuple(state.shape[:2]) != (n_sv, forms.n):
        raise ValueError(
            f"fused {forms.name} step needs a ({n_sv}, {forms.n}, B) state, "
            f"got {tuple(state.shape)}"
        )
    if state.shape[2] < 1:
        raise ValueError("fused step needs a batch of at least one member")
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if state.requires_grad:
        raise NotImplementedError(
            "the fused step is forward-only: gradients through it are "
            "ROADMAP M9 (use the library leapfrog to differentiate)"
        )
    if forms.consts is None:
        raise NotImplementedError(
            f"{forms.name}: per-member or gradient-carrying physical "
            f"parameters (coefficient tables per member) are ROADMAP M9"
        )


def fused_step_reference(
    forms: FusedForms,
    state: torch.Tensor,
    dt,
    *,
    iters,
    compensated: bool,
    steps_per_call: int = 1,
) -> torch.Tensor:
    """The plain PyTorch version of the fused kernel: ``steps_per_call``
    generalized Störmer-Verlet steps of a ``(n_sv, n, B)`` state, as an
    eager mirror of the kernel's arithmetic on ``(B,)`` member columns, in
    the same operation order (step 0 factorizes afresh; steps 1..S−1 reuse
    the previous step's end-of-step factor and aux).  Runs on any device;
    returns a new state tensor."""
    _check_state(forms, state, compensated, steps_per_call)
    iters_p, iters_q = _iters_pair(iters)
    n = forms.n
    fam = forms.make(forms.const_accessors(), FM_TORCH)
    increments = _make_increments(fam, n, iters_p, iters_q)
    dt_t = torch.tensor(float(dt), dtype=state.dtype, device=state.device)
    step_once = _build_step_once(increments, n, compensated, dt_t, dt_t * 0.5)
    st = tuple(tuple(state[v, i] for i in range(n)) for v in range(state.shape[0]))
    st, fac = step_once(st, None)
    for _ in range(steps_per_call - 1):
        st, fac = step_once(st, fac)
    return torch.stack([torch.stack(cols) for cols in st])


# ----------------------------------------------------------------------
# The Hopper kernel's wrapper
# ----------------------------------------------------------------------

#: Family name → the kernel's linear-algebra variant.
_KERNEL_FAMILIES = {"serial_chain_on": "semiseparable", "serial_chain": "dense"}

#: The (variant, n) pairs compiled into csrc/fused_step.cu, each for float32
#: and float64, compensated or not.  Keep in step with its dispatch table.
KERNEL_INSTANTIATIONS = (("semiseparable", 20), ("semiseparable", 5), ("dense", 2))

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def check_kernel_args(device, dtype, forms: FusedForms, shape) -> None:
    """Raise unless the kernel is compiled for this call: a CUDA device, a
    float32/float64 state, and an instantiated (family, n) pair.  Takes a
    device (or its string) so the check is testable without a card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the fused-step kernel runs on CUDA, not {device}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the fused-step kernel takes float32 or float64, not {dtype}"
        )
    variant = _KERNEL_FAMILIES.get(forms.name)
    if (variant, forms.n) not in KERNEL_INSTANTIATIONS:
        raise ValueError(
            f"no fused-step kernel is compiled for family {forms.name!r} at "
            f"n={forms.n}; instantiated (variant, n): "
            f"{list(KERNEL_INSTANTIATIONS)} (serial_chain_on = semiseparable, "
            f"serial_chain = dense), each in float32 and float64"
        )
    if len(shape) != 3 or shape[1] != forms.n or shape[0] not in (4, 6):
        raise ValueError(
            f"the fused-step kernel takes a (4 or 6, {forms.n}, B) state, "
            f"got {tuple(shape)}"
        )


def coef_table(forms: FusedForms, device, dtype) -> torch.Tensor:
    """The kernel's flat coefficient table for ``forms`` (``coef=`` of
    :func:`fused_step_kernel`; the stepper builds it once per device)."""
    flat = [v for table in forms.consts for v in table]
    return torch.tensor(flat, device=device, dtype=dtype)


def fused_step_kernel(
    forms: FusedForms,
    state: torch.Tensor,
    dt,
    *,
    iters,
    compensated: bool,
    steps_per_call: int = 1,
    coef: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the Hopper kernel (``csrc/fused_step.cu``) on a CUDA state:
    ``steps_per_call`` steps of the ``(n_sv, n, B)`` state into a new tensor
    (allocated here; the kernel allocates nothing).  ``coef`` is the flat
    coefficient table on the state's device (built from ``forms.consts``
    when None).  Launches on the current stream without synchronizing."""
    _check_state(forms, state, compensated, steps_per_call)
    check_kernel_args(state.device, state.dtype, forms, tuple(state.shape))
    iters_p, iters_q = _iters_pair(iters)
    if not state.is_contiguous():
        raise ValueError("the fused-step kernel needs a contiguous state")
    if coef is None:
        coef = coef_table(forms, state.device, state.dtype)
    if (coef.device != state.device or coef.dtype != state.dtype
            or not coef.is_contiguous()
            or coef.numel() != sum(forms.coef_lens)):
        raise ValueError(
            f"coefficient table must be a contiguous ({sum(forms.coef_lens)},) "
            f"{state.dtype} tensor on {state.device}"
        )
    out = torch.empty_like(state)
    kernels.fused_step_launch(
        dtype_code=_DTYPE_CODES[state.dtype],
        n=forms.n,
        semiseparable=_KERNEL_FAMILIES[forms.name] == "semiseparable",
        compensated=compensated,
        coef=coef.data_ptr(),
        state_in=state.data_ptr(),
        state_out=out.data_ptr(),
        batch=state.shape[2],
        dt=float(dt),
        iters_p=iters_p,
        iters_q=iters_q,
        steps_per_call=steps_per_call,
        stream=torch.cuda.current_stream(state.device).cuda_stream,
    )
    return out


def fused_step(
    forms: FusedForms,
    state: torch.Tensor,
    dt,
    *,
    iters,
    compensated: bool,
    steps_per_call: int = 1,
    coef: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``steps_per_call`` fused steps: the kernel for a CUDA state, the plain
    version for a CPU state, and an error for anything else."""
    if state.device.type == "cuda":
        return fused_step_kernel(
            forms, state, dt, iters=iters, compensated=compensated,
            steps_per_call=steps_per_call, coef=coef,
        )
    if state.device.type == "cpu":
        return fused_step_reference(
            forms, state, dt, iters=iters, compensated=compensated,
            steps_per_call=steps_per_call,
        )
    raise ValueError(f"no fused step for device {state.device}")


def fused_stepper(
    forms: FusedForms,
    *,
    iters=(3, 1),
    compensated: bool = False,
    steps_per_call: int = 1,
):
    """A fused whole-step leapfrog :class:`Stepper` from a family's
    :class:`FusedForms`.

    ``iters=(iters_p, iters_q)`` are the momentum/position fixed-point
    counts; ``iters_q=0`` selects the predictor-factor (Gauss-Seidel) mode.
    ``steps_per_call`` dt-steps run per ``step`` call (reported as
    ``.substeps``).  Any batch size.  The carry is the ``(n_sv, n, B)``
    state tensor; ``extract`` returns ``(B, n)`` phases.
    """
    iters = _iters_pair(iters)
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if forms.consts is None:
        raise NotImplementedError(
            f"{forms.name}: per-member or gradient-carrying physical "
            f"parameters (coefficient tables per member) are ROADMAP M9"
        )
    n = forms.n
    coef_cache = {}

    def init(ph: Phase) -> torch.Tensor:
        if ph.q.ndim != 2 or ph.q.shape[-1] != n:
            raise ValueError(
                f"fused {forms.name} stepper needs (B, {n}) states, got "
                f"{tuple(ph.q.shape)} (single trajectories and other shapes: "
                f"use the library leapfrog)"
            )
        q, p = ph.q.T, ph.p.T
        z = torch.zeros_like(q)
        # trailing (a_est, vdot_est) warm-start carries start at zero (the
        # cold start)
        parts = (q, p, z, z, z, z) if compensated else (q, p, z, z)
        return torch.stack(parts).contiguous()

    def step(carry: torch.Tensor, dt) -> torch.Tensor:
        coef = None
        if carry.device.type == "cuda":
            key = (carry.device, carry.dtype)
            if key not in coef_cache:
                coef_cache[key] = coef_table(forms, carry.device, carry.dtype)
            coef = coef_cache[key]
        return fused_step(
            forms, carry, dt, iters=iters, compensated=compensated,
            steps_per_call=steps_per_call, coef=coef,
        )

    def extract(carry: torch.Tensor) -> Phase:
        return Phase(carry[0].T, carry[1].T)

    return Stepper(init, step, extract, order=2, symplectic=True,
                   substeps=steps_per_call)
