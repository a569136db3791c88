"""Simulation drivers: the public ``stepHam``/``evolveHam`` API surface.

PyTorch counterpart of :mod:`hamilton_tpu.integrators.evolve`:

* :func:`evolve_ham` — adaptive evolution to a vector of output times, GSL
  RKF45 semantics by default (``evolveHam``, ``Numeric/Hamilton.hs:433-462``);
* :func:`evolve_ham_list` — list-in/list-out convenience incl. the
  singleton-times ``[x] -> [0, x]`` quirk (``evolveHam'``, ``:409-429``);
* :func:`step_ham` — single-timestep convenience (``stepHam``, ``:389-402``;
  like the reference it runs the full adaptive solve over ``[0, dt]`` with
  initial step ``dt/100``) and :func:`iterate_ham`, its stream;
* :func:`step_ham_c` / :func:`evolve_ham_c` / :func:`evolve_ham_c_list` —
  configuration-space wrappers (``:470-515``); the simulation itself always
  runs in phase space.

* :func:`evolve_ham_fixed` — fixed-step evolution with chunked emission, for
  every method of :data:`~hamilton_tpu_torch.integrators.fixed.FIXED_METHODS`
  (``gauss4`` by default).  Everything is differentiable (the library
  methods through the K2 entries' backwards, the fused methods through the
  fused step's replay).
"""

from __future__ import annotations

import functools
import types
from typing import List, Optional, Sequence

import torch

from hamilton_tpu_torch.integrators.adaptive import GSL_EPS_DEFAULT, gsl_evolve_to
from hamilton_tpu_torch.integrators.fixed import make_stepper
from hamilton_tpu_torch.mechanics import from_phase, ham_rhs, to_phase
from hamilton_tpu_torch.state import Config, Phase
from hamilton_tpu_torch.system import System

__all__ = [
    "step_ham",
    "iterate_ham",
    "evolve_ham",
    "evolve_ham_list",
    "evolve_ham_fixed",
    "step_ham_c",
    "evolve_ham_c",
    "evolve_ham_c_list",
]


def _times(ts, like: torch.Tensor) -> torch.Tensor:
    """Times as a tensor in ``like``'s dtype and on its device; Python or
    numpy values are read in float64 first, so ``0.1`` is not rounded to
    float32 on the way."""
    if not isinstance(ts, torch.Tensor):
        ts = torch.as_tensor(ts, dtype=torch.float64)
    return ts.to(dtype=like.dtype, device=like.device)


def evolve_ham(
    system: System,
    phase0: Phase,
    ts,
    *,
    eps_abs: float = GSL_EPS_DEFAULT,
    eps_rel: float = GSL_EPS_DEFAULT,
    h0: Optional[float] = None,
    method: str = "rkf45",
    batch_mode: str = "shared",
    return_stats: bool = False,
):
    """Evolve through phase space, emitting the state at each time in ``ts``.

    The output has leading axis ``len(ts)`` with ``out[0] == phase0``, the
    default initial step is ``(ts[1]-ts[0])/100`` and the default tolerances
    are GSL's ``1.49012e-08``.  ``len(ts) >= 2`` is required, mirroring the
    reference's ``2 <= s`` constraint; use :func:`evolve_ham_list` for looser
    semantics.  The suggested step size carries across output intervals as
    GSL's driver does.

    ``batch_mode`` selects the step controller for *batched* states:

    * ``"shared"`` (default) — one controller for the whole batch, with the
      error norm maximized over all members: every member takes identical
      steps (lock-step);
    * ``"per_member"`` — each member carries its own controller:
      step-for-step equivalent to independent single runs.  The RHS is
      evaluated on the whole batch until the slowest member finishes its
      interval; finished members keep their state.

    ``return_stats=True`` returns ``(trajectory, stats)`` with aggregate
    controller diagnostics: ``saturated`` — True if any interval (of any
    member) exhausted the controller's ``max_steps`` progress guard;
    ``max_interval_steps`` / ``total_failed`` attempt counters.
    """
    y0 = phase0.flatten()
    ts = _times(ts, y0)
    if ts.ndim != 1 or ts.shape[0] < 2:
        raise ValueError(
            f"evolve_ham requires at least 2 output times (got shape "
            f"{tuple(ts.shape)}); this mirrors the reference's `2 <= s` "
            f"constraint (Hamilton.hs:435)"
        )
    if batch_mode not in ("shared", "per_member"):
        raise ValueError(f"unknown {batch_mode=}; use 'shared' or 'per_member'")
    h = (ts[1] - ts[0]) / 100.0 if h0 is None else _times(h0, y0)
    per_member = batch_mode == "per_member" and y0.ndim > 1
    rhs = ham_rhs(system)

    y, ys, sts = y0, [y0], []
    for i in range(ts.shape[0] - 1):
        y, h, st = gsl_evolve_to(
            rhs, y, ts[i], ts[i + 1], h, eps_abs=eps_abs, eps_rel=eps_rel,
            method=method, return_stats=True, per_member=per_member,
        )
        ys.append(y)
        sts.append(st)
    out = Phase.unflatten(torch.stack(ys))
    if not return_stats:
        return out
    # aggregate over the intervals and any per-member controllers
    stats = {
        "saturated": torch.stack([s["saturated"].any() for s in sts]).any(),
        "max_interval_steps": torch.stack([s["n_steps"].max() for s in sts]).max(),
        "total_failed": torch.stack([s["n_failed"].sum() for s in sts]).sum(),
    }
    return out, stats


def evolve_ham_list(
    system: System,
    phase0: Phase,
    ts: Sequence[float],
    **kwargs,
):
    """List-based evolution with the reference's quirk semantics
    (``evolveHam'``): an empty time list returns ``[]``; a singleton ``[x]``
    is padded to ``[0, x]`` and only the state at ``x`` is returned;
    otherwise identical to :func:`evolve_ham`.  Returns a Python list of
    :class:`Phase` (and the stats when ``return_stats=True``)."""
    ts = list(ts)
    if not ts:
        return []
    singleton = len(ts) == 1
    ts_eff = [0.0, ts[0]] if singleton else ts
    out = evolve_ham(system, phase0, ts_eff, **kwargs)
    stats = None
    if kwargs.get("return_stats"):
        out, stats = out
    phases = [Phase(out.q[i], out.p[i]) for i in range(len(ts_eff))]
    phases = phases[1:] if singleton else phases
    return (phases, stats) if stats is not None else phases


def step_ham(system: System, phase0: Phase, dt: float, **kwargs):
    """Advance one timestep ``dt`` through phase space (``stepHam``): the
    full adaptive solve over ``[0, dt]`` (initial step ``dt/100``), returning
    the endpoint.  Argument order is pythonized — the reference's is
    ``stepHam dt system phase``."""
    out = evolve_ham(system, phase0, [0.0, dt], **kwargs)
    if kwargs.get("return_stats"):
        out, stats = out
        return Phase(out.q[1], out.p[1]), stats
    return Phase(out.q[1], out.p[1])


def iterate_ham(system: System, phase0: Phase, dt: float, **kwargs):
    """Infinite stream of states every ``dt``, starting with ``phase0`` (the
    reference README's ``iterate (stepHam 0.1 doublePendulum) phase0``), as a
    Python generator: each element is one :func:`step_ham` from the last."""
    ph = phase0
    while True:
        yield ph
        ph = step_ham(system, ph, dt, **kwargs)


def _carry_leaves(carry) -> List[torch.Tensor]:
    """The tensors of a stepper's carry (a tensor, a :class:`Phase`, or
    tuples and named tuples of them), depth first."""
    if isinstance(carry, torch.Tensor):
        return [carry]
    if isinstance(carry, Phase):
        return [carry.q, carry.p]
    return [t for part in carry for t in _carry_leaves(part)]


def _rebuild(like, leaves):
    """``like``'s structure around the next tensors of ``leaves``."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if isinstance(like, Phase):
        return Phase(next(leaves), next(leaves))
    parts = [_rebuild(part, leaves) for part in like]
    return type(like)(*parts) if hasattr(like, "_fields") else tuple(parts)


def _captured_tensors(obj, found: dict, seen: set, depth: int = 0) -> None:
    """The tensors needing a gradient that ``obj`` reaches: itself, a
    function's closure cells, defaults and the globals its code names, a
    bound method's object, a partial's arguments, a container's items, a
    module's parameters and buffers, and a :class:`System`'s functions,
    inertia and params.  Collected into ``found`` by id, in the order met."""
    if depth > 12 or id(obj) in seen:
        return
    seen.add(id(obj))
    rec = lambda x: _captured_tensors(x, found, seen, depth + 1)  # noqa: E731
    if isinstance(obj, torch.Tensor):
        if obj.requires_grad:
            found.setdefault(id(obj), obj)
    elif isinstance(obj, System):
        for name in ("_inertia", "params", "coords", "potential", "inertia_fn",
                     "jacobian_fn", "mass_matrix_fn", "dtdq_fn", "pallas_step",
                     "fused_forms"):
            rec(getattr(obj, name, None))
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for x in obj:
            rec(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            rec(x)
    elif isinstance(obj, torch.nn.Module):
        for x in list(obj.parameters()) + list(obj.buffers()):
            rec(x)
    elif isinstance(obj, functools.partial):
        rec(obj.func), rec(obj.args), rec(obj.keywords)
    elif isinstance(obj, types.MethodType):
        rec(obj.__self__), rec(obj.__func__)
    elif isinstance(obj, types.FunctionType):
        for cell in obj.__closure__ or ():
            try:
                rec(cell.cell_contents)
            except ValueError:  # an empty cell
                pass
        rec(obj.__defaults__), rec(obj.__kwdefaults__)
        codes, names = [obj.__code__], set()
        while codes:
            code = codes.pop()
            names.update(code.co_names)
            codes += [c for c in code.co_consts if isinstance(c, types.CodeType)]
        for name in sorted(names):
            if name in obj.__globals__ and not isinstance(obj.__globals__[name],
                                                          types.ModuleType):
                rec(obj.__globals__[name])


def _unreached(outs, inputs):
    """A tensor needing a gradient that ``outs`` depend on other than
    through ``inputs``, or None: walks the recomputed graph back from
    ``outs``, stopping at the inputs."""
    stop = {x.grad_fn for x in inputs if x.grad_fn is not None}
    leaves = {id(x) for x in inputs if x.grad_fn is None}
    stack = [o.grad_fn for o in outs if o.grad_fn is not None]
    visited = set()
    while stack:
        node = stack.pop()
        if node in visited or node in stop:
            continue
        visited.add(node)
        var = getattr(node, "variable", None)
        if var is not None:  # a leaf's AccumulateGrad
            if id(var) not in leaves:
                return var
            continue
        stack += [f for f, _ in node.next_functions if f is not None]
    return None


class _Remat(torch.autograd.Function):
    """One step call that keeps no intermediates for the backward, which
    runs it again from its saved inputs and differentiates that
    (``evolve_ham_fixed(remat=True)``).  Its inputs are the carry's tensors,
    then every other tensor the step reads that needs a gradient (the
    system's params and inertia, ``dt``, and the tensors its functions
    capture: :func:`_captured_tensors`), so their gradients are returned
    here.  The backward raises if the recomputed step depends on a tensor
    needing a gradient that is not among them, rather than drop its
    gradient.  (``torch.utils.checkpoint``'s saved-tensor hooks would refuse
    the ``torch.func`` transforms of the library leapfrog's force.)"""

    @staticmethod
    def forward(ctx, run, n_carry, *tensors):
        ctx.run, ctx.n_carry = run, n_carry
        ctx.params = tensors[n_carry:]
        ctx.save_for_backward(*tensors[:n_carry])
        return tuple(run(list(tensors[:n_carry])))

    @staticmethod
    def backward(ctx, *grads):
        wanted = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            carry = [t.detach().requires_grad_(w)
                     for t, w in zip(ctx.saved_tensors, wanted)]
            outs = ctx.run(carry)
            inputs = [x for x, w in zip(carry + list(ctx.params), wanted) if w]
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            missed = _unreached([o for o, _ in pairs], inputs)
            if missed is not None:
                raise RuntimeError(
                    f"evolve_ham_fixed(remat=True): the step depends on a tensor of "
                    f"shape {tuple(missed.shape)} that needs a gradient and that the "
                    f"recomputation cannot return one to (it is not in the system's "
                    f"params, inertia or functions' captures); pass it in "
                    f"System.params, or use remat=False")
            got = iter(torch.autograd.grad([o for o, _ in pairs], inputs,
                                           [g for _, g in pairs], allow_unused=True))
        return (None, None) + tuple(next(got) if w else None for w in wanted)


def evolve_ham_fixed(
    system: System,
    phase0: Phase,
    dt,
    n_steps: int,
    *,
    method: str = "gauss4",
    emit_every: int = 1,
    iters=6,
    omega: float = 20.0,
    remat: bool = False,
    compensated: bool = False,
    steps_per_call: int = 1,
    group_unroll: int = 1,
) -> Phase:
    """Fixed-step evolution: ``n_steps`` steps of size ``dt``, emitting every
    ``emit_every``-th state.  Returns a :class:`Phase` whose leading axis has
    ``n_steps // emit_every + 1`` entries, the initial state first; states
    may carry leading batch axes (the fused methods take ``(B, n)``).

    ``steps_per_call`` (fused methods only) runs that many dt-steps in each
    kernel launch; it must divide ``emit_every`` so emissions land on launch
    boundaries.  Everything is differentiable; with ``remat=True`` each step
    call is checkpointed (:class:`_Remat`): the backward keeps the step
    carries and recomputes one call's intermediates at a time.  ``omega`` is
    the binding frequency of the ``tao2``/``tao4`` methods; ``group_unroll``
    (which must be 1) belongs to the TPU kernel's tiling, and the signature
    keeps it.  ``dt`` becomes a 0-d tensor in the state's dtype on its device
    (a fused method keeps a Python float), so no step reads a value back to
    the host.  A plain Python loop; ``n_steps`` must be divisible by
    ``emit_every``."""
    if n_steps % emit_every != 0:
        raise ValueError(f"{n_steps=} not divisible by {emit_every=}")
    if emit_every % steps_per_call != 0:
        raise ValueError(
            f"{emit_every=} not divisible by {steps_per_call=} (emissions "
            f"must land on kernel-call boundaries)"
        )
    if group_unroll != 1:
        raise ValueError(
            f"group_unroll={group_unroll}: the port's kernel takes any batch, "
            f"one thread a member; only 1 is accepted"
        )
    stepper = make_stepper(system, method, iters=iters, omega=omega,
                           compensated=compensated, steps_per_call=steps_per_call)
    if isinstance(dt, torch.Tensor) or not method.endswith("_fused"):
        # in the state's dtype, as the reference takes it; a fused method
        # keeps a Python float, which its launches read without a host sync
        dt = torch.as_tensor(dt, dtype=phase0.q.dtype, device=phase0.q.device)

    params = []
    if remat:
        captured: dict = {}
        _captured_tensors((system, dt), captured, set())
        params = list(captured.values())

    def step(carry):
        if not (remat and torch.is_grad_enabled()):
            return stepper.step(carry, dt)
        leaves = _carry_leaves(carry)

        def run(xs):
            return _carry_leaves(stepper.step(_rebuild(carry, iter(xs)), dt))

        return _rebuild(carry, iter(_Remat.apply(run, len(leaves), *leaves, *params)))

    carry = stepper.init(phase0)
    qs, ps = [phase0.q], [phase0.p]
    for i in range(n_steps // steps_per_call):
        carry = step(carry)
        if ((i + 1) * steps_per_call) % emit_every == 0:
            ph = stepper.extract(carry)
            qs.append(ph.q)
            ps.append(ph.p)
    return Phase(torch.stack(qs), torch.stack(ps))


# ----------------------------------------------------------------------
# Configuration-space wrappers (reference Hamilton.hs:470-515)
# ----------------------------------------------------------------------


def step_ham_c(system: System, config0: Config, dt: float, **kwargs):
    """``fromPhase ∘ stepHam ∘ toPhase`` (reference ``stepHamC``)."""
    out = step_ham(system, to_phase(system, config0), dt, **kwargs)
    if kwargs.get("return_stats"):
        ph, stats = out
        return from_phase(system, ph), stats
    return from_phase(system, out)


def evolve_ham_c(system: System, config0: Config, ts, **kwargs):
    """Configuration-space ``evolveHam`` (reference ``evolveHamC``): a
    :class:`Config` with a leading time axis."""
    out = evolve_ham(system, to_phase(system, config0), ts, **kwargs)
    if kwargs.get("return_stats"):
        out, stats = out
        return from_phase(system, out), stats
    return from_phase(system, out)  # batch-aware over the leading time axis


def evolve_ham_c_list(
    system: System, config0: Config, ts: Sequence[float], **kwargs
) -> List[Config]:
    """Configuration-space ``evolveHam'`` (reference ``evolveHamC'``)."""
    out = evolve_ham_list(system, to_phase(system, config0), ts, **kwargs)
    if kwargs.get("return_stats") and isinstance(out, tuple):
        phases, stats = out
        return [from_phase(system, ph) for ph in phases], stats
    return [from_phase(system, ph) for ph in out]
