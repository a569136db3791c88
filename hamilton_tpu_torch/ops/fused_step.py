"""Fused whole-step leapfrog: the closed-form family interface, its plain
PyTorch version, and the wrapper of the hand-written Hopper kernel.

PyTorch counterpart of ``hamilton_tpu/ops/pallas_step.py``.  A system family
whose physics admit *closed forms* states them once, as a
:class:`FusedForms` contract, against entry accessors ``at`` and a math
namespace ``fm`` (:data:`FM_TORCH`); the same family code then evaluates on
``(B,)`` member columns (the plain version, :func:`fused_step_reference`)
and runs inside the CUDA kernels — ``csrc/fused_step.cu``,
``csrc/semisep_wide.cu`` and ``csrc/chain_variants.cu`` for the serial
chain, ``csrc/family_step.cu`` for the bundled model families (spherical
pendulum, two-body, room, spring, ellipse, Bézier), and for any other
family (a user's own, or a bundled one
at a size not compiled) ``csrc/user_family_step.cu`` around code generated
from the family's forms at first use (:mod:`~hamilton_tpu_torch.ops.
fused_codegen`), on the one-thread step template of
``csrc/fused_step.cuh`` (the chain's L⁻¹ form on the lane template of
``csrc/chain_lanes.cuh``, several threads a member) — which compute the
identical arithmetic in the same order.

The state of a fused stepper is one contiguous tensor ``(n_sv, n, B)``
(batch-minor, so the kernel's loads and stores coalesce): ``q, p, a_est,
vdot_est`` — plus the Kahan residuals ``cq, cp`` after ``p`` when
``compensated`` (``n_sv`` is 4 or 6).  ``steps_per_call`` dt-steps run per
call; inside a call the end-of-step factor and aux ride to the next step
(step 0 is peeled and factorizes afresh — the factor never crosses calls).
Each dt-step runs the ``composition`` substeps (``(1.0,)`` is plain Verlet;
:data:`YOSHIDA4_COMPOSITION` and :data:`SUZUKI4_COMPOSITION` are order 4),
the factor carried across them.

The coefficient tables are shared by every member when the physical
parameters are concrete and unbatched (``FusedForms.consts``), or per member
for a parameter sweep: ``FusedForms.arrays_fn`` builds them, and the stepper
carries them as one batch-minor ``(L, B)`` table beside the state.

A tensor on the CPU runs the plain version; a CUDA tensor launches the
kernel: the hand-written one for the families and sizes of
:data:`KERNEL_INSTANTIATIONS`, the generated one for every other family
(built by nvcc at first use; a build or launch that fails raises, and forms
that cannot be generated raise ``fused_codegen.GenerationError``).  Other
dtypes than float32/float64 raise.

Gradients: :func:`fused_step` is differentiable in the state, ``dt`` and
the coefficient table.  Its backward replays the plain version from the
saved inputs, one ``torch.utils.checkpoint`` per step, and differentiates
that (the reference's custom VJP over ``_replay``): the kernel has no
backward of its own, as the TPU kernel had none.  Physical parameters that
need a gradient make the table a run-time one (``FusedForms.consts`` is
None): shared parameters give a shared ``(L,)`` table, built by
``arrays_fn`` and differentiable back to them, which the kernel reads in its
shared mode.
"""

from __future__ import annotations

import functools
import types
import weakref
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from hamilton_tpu_torch import kernels
from hamilton_tpu_torch.integrators.fixed import Stepper, _iters_pair, _kahan_add
from hamilton_tpu_torch.ops import fused_codegen
from hamilton_tpu_torch.state import Phase

__all__ = [
    "YOSHIDA4_COMPOSITION",
    "SUZUKI4_COMPOSITION",
    "FUSED_COMPOSITIONS",
    "FusedForms",
    "FamilyFns",
    "FM_TORCH",
    "KERNEL_INSTANTIATIONS",
    "concrete_vec",
    "concrete_scalar",
    "coef_table",
    "member_table",
    "serial_chain_forms",
    "serial_chain_forms_on",
    "serial_chain_forms_mobius",
    "serial_chain_forms_linv",
    "fused_step",
    "fused_step_kernel",
    "fused_step_reference",
    "fused_stepper",
]


# Yoshida/Suzuki triple jump over a symmetric order-2 base: raises to order 4
# (copied from hamilton_tpu/ops/pallas_step.py; a test holds them equal)
_GAMMA = 2.0 ** (1.0 / 3.0)
YOSHIDA4_COMPOSITION = (
    1.0 / (2.0 - _GAMMA), -_GAMMA / (2.0 - _GAMMA), 1.0 / (2.0 - _GAMMA),
)

# Suzuki's 5-stage fractal composition (Suzuki 1990), order 4 over a
# symmetric order-2 base: two more substeps than the triple jump, but every
# |w| ≤ 0.42 (the triple jump's middle weight is ≈ −1.70), so the cheap
# predictor-factor (2, 0) schedule still converges in each substep.  The
# middle weight 1 − 4·S5 is negative.
_S5 = 1.0 / (4.0 - 4.0 ** (1.0 / 3.0))
SUZUKI4_COMPOSITION = (_S5, _S5, 1.0 - 4.0 * _S5, _S5, _S5)

#: The composition of each fused method of ``integrators.fixed.make_stepper``.
FUSED_COMPOSITIONS = {
    "leapfrog_fused": (1.0,),
    "yoshida4_fused": YOSHIDA4_COMPOSITION,
    "suzuki4_fused": SUZUKI4_COMPOSITION,
}

#: The most composition weights the kernel takes (its launch copies them into
#: the kernel's parameters).
MAX_COMPOSITION = 5


def _suffix_sums(xs):
    out, acc = [], 0.0
    for x in reversed(xs):
        acc += float(x)
        out.append(acc)
    return list(reversed(out))


def concrete_vec(x, n: int):
    """``x`` as a list of n Python floats when it is a plain sequence or an
    unbatched 1-D tensor that needs no gradient, else None (the per-member
    coefficient mode)."""
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
    parameter is concrete and shared, else None; ``make(at, fm) →
    FamilyFns`` builds the closed forms against entry accessors ``at[t](i)``
    and math namespace ``fm``; ``name`` names the family (and selects its
    compiled kernel).  ``arrays_fn(dtype, device)`` materializes each table
    as a tensor of shape ``lead + (coef_lens[t],)``, ``lead`` being ``()``
    or ``(B,)`` (a parameter sweep); it is read when ``consts`` is None
    (batched parameters, or parameters that need a gradient).
    ``kernel_consts``: the kernel's flat shared table where it is not
    ``consts`` flattened — the entries with the Python-float factors that
    the forms fold into them in double on the shared path (Bézier's
    binomials), so the kernel reads the values the forms compute.  Such a
    family sets ``runtime_shared`` False: its unbatched run-time table then
    runs in the kernel's per-member mode, broadcast to every member.
    """

    n: int
    n_aux: int
    coef_lens: Tuple[int, ...]
    consts: Optional[Tuple[Tuple[float, ...], ...]]
    make: Callable[..., FamilyFns]
    name: str = "family"
    arrays_fn: Optional[Callable[..., Tuple[torch.Tensor, ...]]] = None
    kernel_consts: Optional[Tuple[float, ...]] = None
    runtime_shared: bool = True

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


def _table_input(x, dtype, device) -> torch.Tensor:
    """A physical parameter (sequence, scalar or tensor) as a tensor for
    ``arrays_fn``; a tensor keeps its gradient."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(x, device=device, dtype=dtype)


def _suffix(m: torch.Tensor) -> torch.Tensor:
    """The suffix mass sums ``S_r = Σ_{k≥r} m_k`` over the last axis."""
    return torch.flip(torch.cumsum(torch.flip(m, (-1,)), -1), (-1,))


def _needs_grad(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def _tree_sum(terms):
    """Balanced pairwise sum of a list of per-member values (the
    reference's ``_tree_sum``): depth ⌈log₂ k⌉ instead of k − 1, the same
    adds, paired as the kernel pairs them."""
    terms = list(terms)
    while len(terms) > 1:
        nxt = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


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

    def arrays_fn(dtype, device):
        """The flat tables ``(C, g·l·S)`` from the (possibly batched)
        parameters, computed in ``dtype`` as the reference's do."""
        m_, l_, g_ = (_table_input(x, dtype, device) for x in (masses, lengths, gravity))
        suffix = _suffix(m_)
        # S_max(i,j) = min(S_i, S_j): the suffix sums are non-increasing
        smax = torch.minimum(suffix[..., :, None], suffix[..., None, :])
        cmat = l_[..., :, None] * l_[..., None, :] * smax
        gu = g_[..., None] * l_ * suffix
        return cmat.reshape(cmat.shape[:-2] + (n * n,)), gu

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
        name="serial_chain", arrays_fn=arrays_fn,
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

    def arrays_fn(dtype, device):
        """The flat table ``(l, S, g·l·S)``, 3n entries a member."""
        m_, l_, g_ = (_table_input(x, dtype, device) for x in (masses, lengths, gravity))
        suffix = _suffix(m_)
        gu = g_[..., None] * l_ * suffix
        lead = torch.broadcast_shapes(l_.shape[:-1], suffix.shape[:-1], gu.shape[:-1])
        parts = [t.expand(*lead, n) for t in (l_, suffix, gu)]
        return (torch.cat(parts, dim=-1),)

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
        name="serial_chain_on", arrays_fn=arrays_fn,
    )


def serial_chain_forms_mobius(masses, lengths, gravity) -> FusedForms:
    """:func:`serial_chain_forms_on` with the semiseparable Cholesky's 2×2
    Riccati recursion collapsed to a scalar Möbius chain (the reference's
    ``serial_chain_forms_mobius``).

    The running factor state is ``W_a = δ_a·I + β_{a−1}·f̂f̂ᵀ`` with ``δ_a``
    the processed link's mass, and ``β = p/q`` obeys, in homogeneous form,
    ``p' = p + δ_a·q``, ``q' = (σ_a/δ_a)·p + q`` with ``σ_a = sin²(θ_a −
    θ_{a−1})``: two multiply-adds a link on the critical path, no division
    and no square root; β, ``y``, ``d`` and ``z`` are per-link work off it.
    The factor has the base family's 5n-entry layout, so the solves and
    ``∂H/∂q`` are the base family's.  The table is 5n entries a member,
    ``(l, S, g·l·S, m, 1/m)``; in exact arithmetic the factor equals the
    base family's.
    """
    base = serial_chain_forms_on(masses, lengths, gravity)
    n = base.n
    m_c = concrete_vec(masses, n)
    consts = None
    if base.consts is not None:
        consts = (base.consts[0] + tuple(m_c) + tuple(1.0 / m for m in m_c),)

    def arrays_fn(dtype, device):
        """The flat table ``(l, S, g·l·S, m, 1/m)``, 5n entries a member."""
        (head,) = base.arrays_fn(dtype, device)
        m_ = _table_input(masses, dtype, device)
        m_ = m_.expand(*head.shape[:-1], n)
        return (torch.cat([head, m_, 1.0 / m_], dim=-1),)

    def make(at, fm):
        # the base family against the 3n prefix of the 5n table
        fam = base.make(at, fm)
        l_at = lambda i: at[0](i)              # noqa: E731
        m_at = lambda i: at[0](3 * n + i)      # noqa: E731  δ by link index
        im_at = lambda i: at[0](4 * n + i)     # noqa: E731  1/δ

        def factor(aux_v, q):
            s, c = aux_v[:n], aux_v[n:]
            # per-link prep (tip-to-base processing order a; link n−1−a)
            idx = [n - 1 - a for a in range(n)]
            ux = [l_at(i) * c[i] for i in idx]
            uy = [l_at(i) * s[i] for i in idx]
            # cross_a = û_{a−1} × û_a = sin(θ_a − θ_{a−1});  σ_a = cross²
            cross = [None] + [
                c[idx[a - 1]] * s[idx[a]] - s[idx[a - 1]] * c[idx[a]]
                for a in range(1, n)
            ]
            sig = [None] + [cross[a] * cross[a] for a in range(1, n)]
            # the critical-path chain: the homogeneous Möbius pair (p, q)
            ps, qs = [None] * n, [None] * n
            ps[0] = fm.full(m_at(idx[0]), s[0])
            qs[0] = fm.full(1.0, s[0])
            for a in range(1, n):
                da, ida = m_at(idx[a]), im_at(idx[a])
                ps[a] = ps[a - 1] + da * qs[a - 1]
                qs[a] = (sig[a] * ida) * ps[a - 1] + qs[a - 1]
            # off-chain reconstruction, independent per link
            zxs, zys, ids = [], [], []
            for a in range(n):
                da = m_at(idx[a])
                if a == 0:
                    yx = da * ux[0]
                    yy = da * uy[0]
                else:
                    beta = ps[a - 1] / qs[a - 1]
                    # f̂_{a−1} = rot90(û_{a−1});  f̂·ũ_a = l_a·cross_a
                    bfu = beta * (l_at(idx[a]) * cross[a])
                    yx = da * ux[a] - bfu * s[idx[a - 1]]
                    yy = da * uy[a] + bfu * c[idx[a - 1]]
                d2 = ux[a] * yx + uy[a] * yy
                inv_d = 1.0 / fm.sqrt(d2)
                zxs.append(yx * inv_d)
                zys.append(yy * inv_d)
                ids.append(inv_d)
            return tuple(zxs + zys + ids + ux + uy)

        return FamilyFns(fam.aux, fam.k_at, fam.dhdq, fam.potential,
                         (factor, fam.factor_solve[1]), aux_shift=fam.aux_shift)

    return FusedForms(
        n=n, n_aux=base.n_aux, coef_lens=(5 * n,), consts=consts, make=make,
        name="serial_chain_mobius", arrays_fn=arrays_fn,
    )


def serial_chain_forms_linv(masses, lengths, gravity) -> FusedForms:
    """:func:`serial_chain_forms_on` with the explicit inverse Cholesky
    factor (the reference's ``serial_chain_forms_linv``).

    The factorization adds, after the O(n) semiseparable one, the n(n+1)/2
    entries of ``L⁻¹`` (column-major lower triangle in the tip-to-base
    processing order), n mutually independent O(n) column recursions::

        col a:  x_a = 1/d_a;  s = z_a·x_a;
                x_i = −(1/d_i)·(u_i·s),  s += z_i·x_i     (i > a)

    so each solve is two triangular mat-vecs with balanced (:func:`_tree_sum`)
    reductions, depth ~⌈log₂ n⌉ instead of two depth-n recursions.  The
    table is the base family's 3n entries; fixed points are the same.
    """
    base = serial_chain_forms_on(masses, lengths, gravity)
    n = base.n

    def make(at, fm):
        fam = base.make(at, fm)
        base_factor = fam.factor_solve[0]

        def factor(aux_v, q):
            """The semiseparable factorization, then the L⁻¹ columns."""
            ent = base_factor(aux_v, q)
            zx, zy = ent[0:n], ent[n:2 * n]
            idv = ent[2 * n:3 * n]
            ux, uy = ent[3 * n:4 * n], ent[4 * n:5 * n]
            flat = []
            for a in range(n):
                xa = idv[a]
                col = [xa]
                sx, sy = zx[a] * xa, zy[a] * xa
                for i in range(a + 1, n):
                    xi = -(idv[i] * (ux[i] * sx + uy[i] * sy))
                    col.append(xi)
                    if i < n - 1:
                        sx = sx + zx[i] * xi
                        sy = sy + zy[i] * xi
                flat.extend(col)
            return tuple(flat)

        def solve(ent, b):
            """``x = L⁻ᵀ(L⁻¹ b̃)``, two mat-vecs with balanced reductions;
            ``b`` and the result in link order."""
            linv, k = {}, 0
            for a in range(n):
                for i in range(a, n):
                    linv[(i, a)] = ent[k]
                    k += 1
            bt = [b[n - 1 - a] for a in range(n)]  # processing order
            y = [_tree_sum([linv[(i, a)] * bt[a] for a in range(i + 1)])
                 for i in range(n)]
            xt = [_tree_sum([linv[(i, a)] * y[i] for i in range(a, n)])
                  for a in range(n)]
            return [xt[n - 1 - j] for j in range(n)]

        return FamilyFns(fam.aux, fam.k_at, fam.dhdq, fam.potential,
                         (factor, solve), aux_shift=fam.aux_shift)

    return FusedForms(
        n=n, n_aux=base.n_aux, coef_lens=base.coef_lens, consts=base.consts,
        make=make, name="serial_chain_linv", arrays_fn=base.arrays_fn,
    )


# ----------------------------------------------------------------------
# Dense in-register Cholesky on per-member entries
# (mirror of hamilton_tpu/ops/pallas_solve.py::_chol_entries/_solve_entries)
# ----------------------------------------------------------------------


def _chol_entries(k_at, n: int, sqrt=torch.sqrt):
    """Unrolled Cholesky on per-member entries: the lower factor as a dict
    ``{(i, j): value}`` plus the reciprocal diagonal."""
    low = {}
    inv_diag = [None] * n
    for j in range(n):
        s = k_at(j, j)
        for k in range(j):
            ljk = low[(j, k)]
            s = s - ljk * ljk
        d = sqrt(s)
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


def _factor_solve_fns(fam: FamilyFns, n: int, fm=FM_TORCH):
    if fam.factor_solve is not None:
        return fam.factor_solve

    def factor_fn(aux_v, q):
        low, inv_d = _chol_entries(fam.k_at(aux_v, q), n, fm.sqrt)
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


def _make_increments(fam: FamilyFns, n: int, iters_p: int, iters_q: int,
                     fm=FM_TORCH):
    aux_fn, dhdq = fam.aux, fam.dhdq
    factor_fn, solve_fn = _factor_solve_fns(fam, n, fm)

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


def _weighted(w: float, x):
    """``T(w)·x``: the weight rounded to ``x``'s type first, as the
    reference's product of a Python float with a tile of the state's dtype
    rounds it."""
    if isinstance(x, torch.Tensor):
        return x.new_tensor(w) * x
    return w * x


def _build_step_once(increments, n: int, compensated: bool, dt, half,
                     composition=(1.0,)):
    """One dt-step on per-member values — the ``composition`` substeps, each
    at ``T(w)·dt`` and ``T(w)·half`` with the factor carried across them —
    with or without Kahan-compensated accumulation."""
    if not compensated:

        def step_once(state, fac):
            qs, ps, avs, vds = state
            for w in composition:
                dq, dp, b, vd1, fac = increments(
                    list(qs), list(ps), list(avs), list(vds),
                    _weighted(w, dt), _weighted(w, half), fac0=fac,
                )
                qs = tuple(qs[i] + dq[i] for i in range(n))
                ps = tuple(ps[i] + dp[i] for i in range(n))
                avs, vds = tuple(b), tuple(vd1)
            return (qs, ps, avs, vds), fac

        return step_once

    def step_once(state, fac):
        qs, ps, cqs, cps, avs, vds = state
        for w in composition:
            dq, dp, b, vd1, fac = increments(
                list(qs), list(ps), list(avs), list(vds),
                _weighted(w, dt), _weighted(w, half), fac0=fac,
            )
            q_c = [_kahan_add(qs[i], cqs[i], dq[i]) for i in range(n)]
            p_c = [_kahan_add(ps[i], cps[i], dp[i]) for i in range(n)]
            qs, cqs = tuple(x for x, _ in q_c), tuple(c for _, c in q_c)
            ps, cps = tuple(x for x, _ in p_c), tuple(c for _, c in p_c)
            avs, vds = tuple(b), tuple(vd1)
        return (qs, ps, cqs, cps, avs, vds), fac

    return step_once


@functools.lru_cache(maxsize=None)
def _checked_composition(composition: tuple) -> Tuple[float, ...]:
    composition = tuple(float(w) for w in composition)
    if not 1 <= len(composition) <= MAX_COMPOSITION:
        raise ValueError(
            f"a composition has 1 to {MAX_COMPOSITION} weights, got "
            f"{len(composition)}"
        )
    return composition


def _check_composition(composition) -> Tuple[float, ...]:
    """The weights as a tuple of floats, checked once per composition (a
    launch repeats its stepper's)."""
    return _checked_composition(tuple(composition))


def _check_state(forms: FusedForms, state: torch.Tensor, compensated: bool,
                 steps_per_call: int, coef: Optional[torch.Tensor]):
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
    runtime = forms.consts is None
    if coef is None:
        if runtime:
            raise ValueError(
                f"{forms.name}: run-time parameters (batched, or needing a "
                f"gradient) need their (L, B) or (L,) coefficient table as "
                f"coef= (fused_stepper's init builds it)"
            )
        return
    length = sum(forms.coef_lens)
    wants = [(length,)] + ([(length, state.shape[2])] if runtime else [])
    if (tuple(coef.shape) not in wants or coef.dtype != state.dtype
            or coef.device != state.device or not coef.is_contiguous()):
        raise ValueError(
            f"{forms.name}: the {'shared or per-member' if runtime else 'shared'} "
            f"coefficient table must be a contiguous "
            f"{' or '.join(map(str, wants))} {state.dtype} tensor on "
            f"{state.device}, got {tuple(coef.shape)} {coef.dtype} on "
            f"{coef.device}"
        )


def member_table(forms: FusedForms, batch: int, dtype, device) -> torch.Tensor:
    """The run-time coefficient table of ``forms.arrays_fn``: one shared
    ``(L,)`` tensor when every table is unbatched (parameters that need a
    gradient), else the per-member tables of a parameter sweep as one
    batch-minor ``(L, B)`` tensor, ``L = sum(coef_lens)``, each table either
    unbatched (broadcast to every member) or with a leading batch axis equal
    to the state batch.  A size-1 batch axis is refused, as the library path
    refuses it (its member-wise vmap does not broadcast), so the two paths
    never disagree silently.  Differentiable back to the parameters."""
    if forms.arrays_fn is None:
        raise ValueError(f"{forms.name} has no per-member tables (arrays_fn)")
    tables = forms.arrays_fn(dtype, device)
    if len(tables) != len(forms.coef_lens):
        raise ValueError(
            f"{forms.name}: arrays_fn returned {len(tables)} tables, declared "
            f"{len(forms.coef_lens)}"
        )
    for t, (arr, flat) in enumerate(zip(tables, forms.coef_lens)):
        if arr.ndim < 1 or arr.shape[-1] != flat:
            raise ValueError(
                f"{forms.name}: coefficient table {t} has shape "
                f"{tuple(arr.shape)}, declared flat length {flat}"
            )
    if all(arr.ndim == 1 for arr in tables):
        return torch.cat(tables).contiguous()
    rows = []
    for t, (arr, flat) in enumerate(zip(tables, forms.coef_lens)):
        lead = tuple(arr.shape[:-1])
        if lead == ():
            arr = arr.reshape(1, flat).expand(batch, flat)
        elif lead != (batch,):
            raise ValueError(
                f"batched {forms.name} parameters must carry a leading batch "
                f"axis equal to the state batch ({batch}); got table {t} shape "
                f"{tuple(arr.shape)} (broadcast size-1 axes explicitly, as the "
                f"library path requires)"
            )
        rows.append(arr.T)
    return torch.cat(rows, dim=0).contiguous()


def _accessors(forms: FusedForms, coef: Optional[torch.Tensor]):
    """Entry accessors ``at[t](i)``: Python floats over the shared constant
    tables, 0-d entries of a shared run-time table (they broadcast over the
    members, so a gradient sums over them), or ``(B,)`` rows of a
    per-member table."""
    if forms.consts is not None:
        return forms.const_accessors()
    offsets = [sum(forms.coef_lens[:t]) for t in range(len(forms.coef_lens))]
    return tuple((lambda i, o=o: coef[o + i]) for o in offsets)


def _reference(forms, state, dt, *, iters, compensated, steps_per_call,
               composition, coef, checkpoint):
    """The plain version's steps; ``checkpoint`` wraps each step in a
    ``torch.utils.checkpoint`` (the backward's replay keeps one step's
    intermediates at a time, as the reference's ``_replay`` does)."""
    _check_state(forms, state, compensated, steps_per_call, coef)
    composition = _check_composition(composition)
    iters_p, iters_q = _iters_pair(iters)
    n = forms.n
    fam = forms.make(_accessors(forms, coef), FM_TORCH)
    increments = _make_increments(fam, n, iters_p, iters_q)
    if isinstance(dt, torch.Tensor):
        dt_t = dt.to(dtype=state.dtype, device=state.device)
    else:
        dt_t = torch.tensor(float(dt), dtype=state.dtype, device=state.device)
    step_once = _build_step_once(increments, n, compensated, dt_t, dt_t * 0.5,
                                 composition)
    if checkpoint:
        inner = step_once

        def step_once(st, fac):
            return torch.utils.checkpoint.checkpoint(
                inner, st, fac, use_reentrant=False, preserve_rng_state=False)

    st = tuple(tuple(state[v, i] for i in range(n)) for v in range(state.shape[0]))
    st, fac = step_once(st, None)
    for _ in range(steps_per_call - 1):
        st, fac = step_once(st, fac)
    return torch.stack([torch.stack(cols) for cols in st])


def fused_step_reference(
    forms: FusedForms,
    state: torch.Tensor,
    dt,
    *,
    iters,
    compensated: bool,
    steps_per_call: int = 1,
    composition=(1.0,),
    coef: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the fused kernel: ``steps_per_call``
    generalized Störmer-Verlet steps (each of the ``composition`` substeps)
    of a ``(n_sv, n, B)`` state, as an eager mirror of the kernel's
    arithmetic on ``(B,)`` member columns, in the same operation order (the
    first substep of a call factorizes afresh; every later one reuses the
    previous substep's end-of-step factor and aux).  ``coef`` is the
    kernel's coefficient table (:func:`fused_step_kernel`), checked the same
    way; with constant shared parameters the entries are read as the Python
    floats of ``forms.consts`` it was built from.  ``dt`` is a number or a
    0-d tensor.  Runs on any device; returns a new state tensor, and is
    differentiable as plain PyTorch."""
    return _reference(forms, state, dt, iters=iters, compensated=compensated,
                      steps_per_call=steps_per_call, composition=composition,
                      coef=coef, checkpoint=False)


# ----------------------------------------------------------------------
# The Hopper kernel's wrapper
# ----------------------------------------------------------------------

#: The compiled kernels: ``(family name, n, coefficient-table length)`` →
#: ``(source, code)``.  ``csrc/fused_step.cu`` holds the serial chain (code:
#: its n; ``serial_chain_on`` the semiseparable forms, ``serial_chain`` the
#: dense ones), ``csrc/semisep_wide.cu`` the semiseparable chain at n = 40
#: (code: 40), ``csrc/chain_variants.cu`` the chain's Möbius and L⁻¹ forms
#: and the dense one at n = 4, ``csrc/family_step.cu`` the bundled model
#: families (code: the case of each one's dispatch; the table length tells
#: Bézier's degrees apart).  Each is compiled in float32 and float64,
#: compensated or not, with a shared or a per-member table (room: shared
#: only, it has no parameters), plain or composed.  Keep in step with the
#: three dispatch tables.  Every other family runs on the generated kernel
#: (``csrc/user_family_step.cu``, :mod:`~hamilton_tpu_torch.ops.fused_codegen`).
KERNEL_INSTANTIATIONS = {
    # the headline chain: a member's links on G lanes in G warps, the scans
    # handed from lane to lane (csrc/semisep_wide.cuh), where fused_step.cu
    # routes the dtype and modes there (PERF.md §6)
    ("serial_chain_on", 20, 60): ("fused_step", 20),
    ("serial_chain_on", 5, 15): ("fused_step", 5),
    ("serial_chain", 2, 6): ("fused_step", 2),
    # the reference's default chain and its stress chain, dense: G lanes a
    # member, the factor in shared memory (csrc/dense_lanes.cuh, PERF.md §6)
    ("serial_chain", 20, 420): ("fused_step", 20),
    ("serial_chain", 40, 1640): ("fused_step", 40),
    # the stress chain's semiseparable form: the member's working set in
    # shared memory and registers, G lanes a member (PERF.md §6)
    ("serial_chain_on", 40, 120): ("semisep_wide", 40),
    ("serial_chain_mobius", 20, 100): ("chain_variants", 0),
    ("serial_chain_mobius", 5, 25): ("chain_variants", 1),
    ("serial_chain_linv", 20, 60): ("chain_variants", 2),
    ("serial_chain_linv", 5, 15): ("chain_variants", 3),
    ("serial_chain", 4, 20): ("chain_variants", 4),
    ("spherical_pendulum", 2, 2): ("family_step", 0),
    ("two_body", 2, 2): ("family_step", 1),
    ("room", 2, 0): ("family_step", 2),
    ("spring", 3, 4): ("family_step", 3),
    ("ellipse", 1, 4): ("family_step", 4),
    ("bezier", 1, 14): ("family_step", 5),  # 5 control points (degree 4)
    ("bezier", 1, 2): ("family_step", 6),   # 2 control points (degree 1)
}

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def _kernel_key(forms: FusedForms):
    return forms.name, forms.n, sum(forms.coef_lens)


def check_kernel_args(device, dtype, forms: FusedForms, shape,
                      composition=(1.0,)) -> Tuple[float, ...]:
    """Raise unless a kernel takes this call: a CUDA device, a float32/
    float64 state of shape ``(4 or 6, n, B)`` and at most
    :data:`MAX_COMPOSITION` composition weights; a family outside
    :data:`KERNEL_INSTANTIATIONS` must have forms the generated kernel can
    be made from (traced here, once per forms object; raises
    ``fused_codegen.GenerationError``).  Returns the weights as a tuple of
    floats.  Takes a device (or its string) so the check is testable without
    a card."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the fused-step kernel runs on CUDA, not {device}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"the fused-step kernel takes float32 or float64, not {dtype}"
        )
    if _kernel_key(forms) not in KERNEL_INSTANTIATIONS:
        gen = fused_codegen.generated(forms)
        if forms.consts is not None and gen.const is None:
            raise fused_codegen.GenerationError(gen.const_error)
    if len(shape) != 3 or shape[1] != forms.n or shape[0] not in (4, 6):
        raise ValueError(
            f"the fused-step kernel takes a (4 or 6, {forms.n}, B) state, "
            f"got {tuple(shape)}"
        )
    return _check_composition(composition)


def coef_table(forms: FusedForms, device, dtype) -> torch.Tensor:
    """The kernel's flat ``(L,)`` shared coefficient table for ``forms``
    (``coef=`` of :func:`fused_step_kernel`; the stepper builds it once per
    device): ``forms.kernel_consts``, or the tables of ``forms.consts`` end
    to end.  Empty for a family without parameters (room)."""
    flat = forms.kernel_consts
    if flat is None:
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
    composition=(1.0,),
    coef: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the Hopper kernel (``csrc/fused_step.cu`` or
    ``csrc/chain_variants.cu`` for the serial chain, ``csrc/family_step.cu``
    for the bundled families, the generated ``csrc/user_family_step.cu`` for
    any other family) on a CUDA state: ``steps_per_call`` steps of
    the ``(n_sv, n, B)`` state into a new tensor (allocated here; the kernel
    allocates nothing).  ``coef`` is the kernel's one coefficient table on
    the state's device: a shared ``(L,)`` one (:func:`coef_table`, built here
    when None, or a run-time one from :func:`member_table`) or the per-member
    ``(L, B)`` one of a sweep.  Launches on the current stream without
    synchronizing.  Forward only: :func:`fused_step` differentiates."""
    _check_state(forms, state, compensated, steps_per_call, coef)
    composition = check_kernel_args(state.device, state.dtype, forms,
                                    tuple(state.shape), composition)
    iters_p, iters_q = _iters_pair(iters)
    if not state.is_contiguous():
        raise ValueError("the fused-step kernel needs a contiguous state")
    if _kernel_key(forms) not in KERNEL_INSTANTIATIONS:
        return _generated_step(forms, state, dt, coef, compensated, iters_p, iters_q,
                               steps_per_call, composition)
    if coef is None:
        coef = coef_table(forms, state.device, state.dtype)
    elif coef.ndim == 1 and forms.consts is None and not forms.runtime_shared:
        # the kernel's shared layout differs from arrays_fn's: broadcast
        coef = coef[:, None].expand(-1, state.shape[2]).contiguous()
    out = torch.empty_like(state)
    source, code = KERNEL_INSTANTIATIONS[_kernel_key(forms)]
    _LAUNCH[source](
        dtype_code=_DTYPE_CODES[state.dtype],
        code=code,
        semiseparable=forms.name == "serial_chain_on",
        compensated=compensated,
        per_member=coef.ndim == 2,
        coef=coef.data_ptr(),
        state_in=state.data_ptr(),
        state_out=out.data_ptr(),
        batch=state.shape[2],
        dt=float(dt),
        iters_p=iters_p,
        iters_q=iters_q,
        steps_per_call=steps_per_call,
        weights=composition,
        stream=torch.cuda.current_stream(state.device).cuda_stream,
    )
    return out


#: A generated family's library key and float64 constant tables, by forms
#: object (weakly: a launch asks on every call).
_USER_BUILDS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _generated_step(forms, state, dt, coef, compensated, iters_p, iters_q,
                    steps_per_call, composition):
    """Launch the generated kernel of ``forms``: with constant shared
    parameters on the float64 copy of ``forms.consts`` (the plain version
    reads those Python floats, not ``coef``), else on the run-time shared or
    per-member table ``coef``.  Builds the kernel at first use."""
    built = _USER_BUILDS.get(forms)
    if built is None:
        key, _ = kernels.build_user_family(fused_codegen.generated(forms).header)
        built = _USER_BUILDS[forms] = (key, {})
    key, const_tables = built
    const = forms.consts is not None
    if const:
        coef = const_tables.get(state.device)
        if coef is None:
            flat = [float(v) for table in forms.consts for v in table]
            coef = const_tables[state.device] = torch.tensor(
                flat, dtype=torch.float64, device=state.device)
    out = torch.empty_like(state)
    kernels.user_family_launch(
        key=key,
        dtype_code=_DTYPE_CODES[state.dtype],
        const_table=const,
        compensated=compensated,
        per_member=coef.ndim == 2,
        coef=coef.data_ptr() if coef.numel() else 0,
        state_in=state.data_ptr(),
        state_out=out.data_ptr(),
        batch=state.shape[2],
        dt=float(dt),
        iters_p=iters_p,
        iters_q=iters_q,
        steps_per_call=steps_per_call,
        weights=composition,
        stream=torch.cuda.current_stream(state.device).cuda_stream,
    )
    return out


# each source's launch function: the chain's libraries take n and the
# semiseparable flag, the others the case of their dispatch
_LAUNCH = {
    "fused_step": kernels.fused_step_launch,
    "chain_variants": kernels.chain_variants_launch,
    "semisep_wide": kernels.semisep_wide_launch,
    "family_step": kernels.family_step_launch,
}


def _forward(forms, state, dt, coef, kw):
    """The kernel for a CUDA state, the plain version for a CPU state, an
    error for anything else."""
    if state.device.type == "cuda":
        return fused_step_kernel(forms, state, dt, coef=coef, **kw)
    if state.device.type == "cpu":
        return fused_step_reference(forms, state, dt, coef=coef, **kw)
    raise ValueError(f"no fused step for device {state.device}")


class _FusedStep(torch.autograd.Function):
    """The fused step with a gradient: the forward is the kernel (or the
    plain version on the CPU); the backward replays the plain version from
    the saved inputs, one checkpoint per step, and differentiates it (the
    reference's ``_kernel_step_bwd``)."""

    @staticmethod
    def forward(state, dt, coef, forms, kw):
        return _forward(forms, state, dt, coef, kw)

    @staticmethod
    def setup_context(ctx, inputs, output):
        state, dt, coef, forms, kw = inputs
        ctx.forms, ctx.kw = forms, kw
        ctx.dt = None if isinstance(dt, torch.Tensor) else dt
        ctx.save_for_backward(state, dt if isinstance(dt, torch.Tensor) else None, coef)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        state, dt, coef = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [None if x is None else x.detach().requires_grad_(w)
                      for x, w in zip((state, dt, coef), wanted)]
            out = _reference(ctx.forms, leaves[0], ctx.dt if dt is None else leaves[1],
                             coef=leaves[2], checkpoint=True, **ctx.kw)
            inputs = [x for x, w in zip(leaves, wanted) if w]
            grads = iter(torch.autograd.grad(out, inputs, grad_out, allow_unused=True))
        return tuple(next(grads) if w else None for w in wanted) + (None, None)


def fused_step(
    forms: FusedForms,
    state: torch.Tensor,
    dt,
    *,
    iters,
    compensated: bool,
    steps_per_call: int = 1,
    composition=(1.0,),
    coef: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``steps_per_call`` fused steps: the kernel for a CUDA state, the plain
    version for a CPU state, and an error for anything else.
    Differentiable in ``state``, ``dt`` (a 0-d tensor) and ``coef`` when any
    of them needs a gradient; otherwise no autograd bookkeeping at all."""
    kw = dict(iters=iters, compensated=compensated, steps_per_call=steps_per_call,
              composition=composition)
    if torch.is_grad_enabled() and _needs_grad(state, dt, coef):
        return _FusedStep.apply(state, dt, coef, forms, kw)
    return _forward(forms, state, dt, coef, kw)


def fused_stepper(
    forms: FusedForms,
    *,
    iters=(3, 1),
    compensated: bool = False,
    steps_per_call: int = 1,
    composition=(1.0,),
):
    """A fused whole-step leapfrog :class:`Stepper` from a family's
    :class:`FusedForms`.

    ``iters=(iters_p, iters_q)`` are the momentum/position fixed-point
    counts; ``iters_q=0`` selects the predictor-factor (Gauss-Seidel) mode.
    ``steps_per_call`` dt-steps run per ``step`` call (reported as
    ``.substeps``); each runs the ``composition`` substeps (order 4 for the
    Yoshida/Suzuki weights).  Any batch size.  With constant shared
    parameters the carry is the ``(n_sv, n, B)`` state tensor; with run-time
    parameters (a sweep, or parameters that need a gradient) it is
    ``(state, table)``: ``init`` builds the table once (:func:`member_table`,
    ``(L,)`` shared or ``(L, B)``) and it rides with the state, so a resumed
    run keeps it and a gradient reaches the parameters through it.
    ``extract`` returns ``(B, n)`` phases.
    """
    iters = _iters_pair(iters)
    composition = _check_composition(composition)
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if forms.consts is None and forms.arrays_fn is None:
        raise ValueError(f"{forms.name}: no shared constants and no arrays_fn")
    n = forms.n
    runtime = forms.consts is None
    coef_cache = {}

    def init(ph: Phase):
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
        state = torch.stack(parts).contiguous()
        if not runtime:
            return state
        return state, member_table(forms, q.shape[1], q.dtype, q.device)

    kw = dict(iters=iters, compensated=compensated,
              steps_per_call=steps_per_call, composition=composition)

    def step(carry, dt):
        if runtime:
            state, table = carry
            return fused_step(forms, state, dt, coef=table, **kw), table
        coef = None
        if carry.device.type == "cuda":
            key = (carry.device, carry.dtype)
            if key not in coef_cache:
                coef_cache[key] = coef_table(forms, carry.device, carry.dtype)
            coef = coef_cache[key]
        return fused_step(forms, carry, dt, coef=coef, **kw)

    def extract(carry) -> Phase:
        state = carry[0] if runtime else carry
        return Phase(state[0].T, state[1].T)

    order = 2 if composition == (1.0,) else 4  # symmetric compositions
    return Stepper(init, step, extract, order=order, symplectic=True,
                   substeps=steps_per_call)
