"""Ensemble evolution: trajectories, and the final state with running
energy-drift tracking.

PyTorch counterpart of :mod:`hamilton_tpu.ensemble`: ``evolve_ensemble``
emits the trajectory of a batch through ``evolve_ham_fixed``;
``evolve_ensemble_final`` and ``evolve_ensemble_chunked`` keep only the
final state.  The ensemble is
one batch-native ``(B, n)`` phase; the final-state drivers run an eager Python loop of
``stepper.step`` calls (each call advances ``stepper.substeps`` dt-steps —
50 per launch on the fused kernel's main path) and, every ``drift_every``
dt-steps, fold ``|H(t) − H(0)| / max(|H(0)|, 1)`` into a running per-member
maximum.  Nothing in the loop reads a value back to the host, so on a CUDA
device the launches queue asynchronously.

Parameter sweeps run as they are: a system with ``(B, ...)``-batched
params evolves member by member, the fused stepper's carry holds the
per-member coefficient table beside the state, and the sampler's
Hamiltonian maps each member's params with its state.

The drift sampler measures ``H`` with the port's library
:func:`~hamilton_tpu_torch.mechanics.hamiltonian` on a copy of the system
in ``drift_dtype`` (``torch.float64`` for the f32 headline: the H100 has
hardware f64, so the reference's double-f32 sampler ``ops/df32.py``, which
exists because the TPU emulates f64, is not ported).

``observable=`` with ``obs_every=`` streams a user reduction through the
loop (:mod:`hamilton_tpu_torch.utils.observables`): every ``obs_every``
dt-steps ``observable.update(obs_state, phase, step)`` runs on the current
phase, and a transforming observable's replacement phase re-inits the
stepper carry.

``evolve_ensemble_sharded`` splits the members over a device mesh
(:mod:`hamilton_tpu_torch.parallel`): each shard runs the final-state loop
on its own device, the shards' launches issued in turn at every loop
iteration, and only the statistics cross processes.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Optional

import torch
import torch.distributed as dist

from hamilton_tpu_torch.integrators.evolve import evolve_ham_fixed
from hamilton_tpu_torch.integrators.fixed import make_stepper
from hamilton_tpu_torch.mechanics import hamiltonian
from hamilton_tpu_torch.parallel.mesh import EnsembleMesh, ShardedPhase
from hamilton_tpu_torch.state import Phase
from hamilton_tpu_torch.system import System

__all__ = ["evolve_ensemble", "evolve_ensemble_final", "evolve_ensemble_chunked",
           "evolve_ensemble_sharded"]


def evolve_ensemble(
    system: System,
    phase0: Phase,
    dt: float,
    n_steps: int,
    *,
    method: str = "gauss4",
    emit_every: int = 1,
    iters=6,
    omega: float = 20.0,
    system_batched: bool = False,
    compensated: bool = False,
    steps_per_call: int = 1,
    group_unroll: int = 1,
) -> Phase:
    """Evolve a batch of initial conditions with a fixed-step integrator.

    ``phase0`` carries one leading batch axis; the result has axes
    ``(time, batch, n)``.  A shared system, or one whose ``params`` carry a
    leading batch axis matching the phase batch (a parameter sweep,
    :meth:`System.replace_params`), evolves batch-native through
    :func:`~hamilton_tpu_torch.integrators.evolve.evolve_ham_fixed`: the
    mechanics pair the params member-wise with the state, and on a CUDA
    tensor every solve is one batched kernel launch.

    ``system_batched=True`` declares a system whose tensors carry the batch
    axis: batched params, or a hand-built system's inertia vector
    (:meth:`System.replace_inertia`).  Where the reference maps the whole
    evolution over the system with ``jax.vmap``, the port pairs such an
    inertia with the members as it pairs batched params, so this path is
    the same batch-native one and its solves launch the same kernels.
    """
    if system_batched and system.member_batch_ndim() != 1:
        raise ValueError(
            f"system_batched=True needs a system with one batch axis on its "
            f"params or inertia; this one carries {system.member_batch_ndim()}"
        )
    return evolve_ham_fixed(
        system, phase0, dt, n_steps, method=method, emit_every=emit_every,
        iters=iters, omega=omega, compensated=compensated,
        steps_per_call=steps_per_call, group_unroll=group_unroll,
    )


def _drift_measure(system: System, phase0: Phase, drift_dtype):
    """The energy-drift measurement: ``(measure_h, h0, h_scale)``.

    ``drift_dtype`` (e.g. ``torch.float64``) evaluates ``H`` at higher
    precision than the trajectory — at f32 the evaluation's own rounding
    (~1e-6 relative) would otherwise mask the drift of a compensated run."""
    if isinstance(drift_dtype, str):
        raise NotImplementedError(
            f"drift_dtype={drift_dtype!r}: the double-f32 sampler is not "
            f"ported (ROADMAP M7: the port samples in native float64)"
        )
    if drift_dtype is not None:
        h_system = system.to(dtype=drift_dtype)

        def measure_h(ph):
            return hamiltonian(h_system, ph.astype(drift_dtype))

    else:

        def measure_h(ph):
            return hamiltonian(system, ph)

    h0 = measure_h(phase0)
    h_scale = torch.clamp(torch.abs(h0), min=1.0)
    return measure_h, h0, h_scale


def _final_loop_body(stepper, dt, measure_h, h0, h_scale, drift_every,
                     track_drift, observable=None, obs_every=None, step_offset=0):
    """The hot-loop body shared by both drivers: iteration ``i`` advances
    ``stepper.substeps`` dt-steps; when the global dt-step index is a
    multiple of ``drift_every`` it folds the sampled drift into the running
    maximum, and when it is a multiple of ``obs_every`` it updates the
    observable (re-initing the carry from a transforming observable's
    phase: the Kahan residuals and warm starts restart, as in the
    reference).  ``state`` is ``(carry, drift, obs)``."""
    sub = stepper.substeps
    transforms = getattr(observable, "transforms_state", False)

    def body(i, state):
        carry, drift, obs = state
        carry = stepper.step(carry, dt)
        step = step_offset + (i + 1) * sub
        if track_drift and step % drift_every == 0:
            h = measure_h(stepper.extract(carry))
            drift = torch.maximum(drift, torch.abs(h - h0) / h_scale)
        if observable is not None and step % obs_every == 0:
            ph = stepper.extract(carry)
            if transforms:
                obs, ph = observable.update(obs, ph, step)
                carry = stepper.init(ph)
            else:
                obs = observable.update(obs, ph, step)
        return carry, drift, obs

    return body


def _check_substeps(stepper, n_steps, drift_every, track_drift):
    sub = stepper.substeps
    if n_steps % sub != 0:
        raise ValueError(
            f"{n_steps=} not divisible by the stepper's substeps ({sub})"
        )
    if track_drift and drift_every % sub != 0:
        raise ValueError(
            f"{drift_every=} not divisible by the stepper's substeps ({sub})"
        )
    return sub


def _check_obs_every(observable, obs_every, sub):
    if observable is not None and (obs_every is None or obs_every % sub != 0):
        raise ValueError(
            f"observable needs obs_every set to a multiple of the stepper's "
            f"substeps ({sub}); got {obs_every}"
        )


def _callback_wants_obs(cb) -> bool:
    """True when ``cb`` takes the ``(ci, carry, drift, obs)`` carry-callback
    signature, False for the three-argument ``(ci, carry, drift)`` one;
    callables that cannot be inspected get four."""
    try:
        sig = inspect.signature(cb)
    except (TypeError, ValueError):
        return True
    try:
        sig.bind(0, None, None, None)
        return True
    except TypeError:
        return False


def _sync(t: torch.Tensor) -> None:
    """Wait for the work queued on ``t``'s device (a no-op on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _drift_setup(system: System, phase0: Phase, drift_dtype, track_drift):
    """``(measure_h, h0, h_scale, drift)``: the sampler and a zero running
    maximum, or all None when drift is not tracked (so no Hamiltonian is
    evaluated at all)."""
    if not track_drift:
        return None, None, None, None
    measure_h, h0, h_scale = _drift_measure(system, phase0, drift_dtype)
    return measure_h, h0, h_scale, torch.zeros_like(h0)


def _dt_scalar(dt, phase0: Phase) -> torch.Tensor:
    # a 0-d CPU tensor in the state dtype: the steppers' arithmetic rounds
    # dt as the reference's ``jnp.asarray(dt, dtype)`` does, and reading it
    # on the host (the kernel's launch argument) never waits on the device
    return torch.tensor(float(dt), dtype=phase0.q.dtype)


def evolve_ensemble_final(
    system: System,
    phase0: Phase,
    dt: float,
    n_steps: int,
    *,
    method: str = "gauss4",
    iters=6,
    omega: float = 20.0,
    track_drift: bool = True,
    drift_every: int = 100,
    compensated: bool = False,
    drift_dtype=None,
    steps_per_call: int = 1,
    observable=None,
    obs_every: Optional[int] = None,
):
    """Evolve a ``(B, n)`` batch to its final state without materializing
    trajectories.

    Returns ``(final_phase, max_drift)``: ``max_drift`` is the running
    per-member maximum of ``|H(t) − H(0)| / max(|H(0)|, 1)`` sampled every
    ``drift_every`` dt-steps, or None when ``track_drift=False`` (which
    evaluates no Hamiltonian).  See :func:`_drift_measure` for
    ``drift_dtype``.  With ``observable`` (and ``obs_every``, a multiple of
    the stepper's substeps) it streams that reduction through the loop and
    returns ``(final_phase, max_drift, obs_state)``.
    """
    stepper, body, state, n_iter = _final_setup(
        system, phase0, dt, n_steps, method=method, iters=iters, omega=omega,
        track_drift=track_drift, drift_every=drift_every, compensated=compensated,
        drift_dtype=drift_dtype, steps_per_call=steps_per_call, observable=observable,
        obs_every=obs_every,
    )
    for i in range(n_iter):
        state = body(i, state)
    carry, drift, obs = state
    if observable is not None:
        return stepper.extract(carry), drift, obs
    return stepper.extract(carry), drift


def _final_setup(system, phase0, dt, n_steps, *, method, iters, omega, track_drift,
                 drift_every, compensated, drift_dtype, steps_per_call, observable,
                 obs_every):
    """The final-state loop of :func:`evolve_ensemble_final`, not yet run:
    ``(stepper, body, state, iterations)``, ``body(i, state)`` one
    iteration of it."""
    if n_steps % drift_every != 0:
        raise ValueError(f"{n_steps=} not divisible by {drift_every=}")
    stepper = make_stepper(
        system, method, iters=iters, omega=omega, compensated=compensated,
        steps_per_call=steps_per_call,
    )
    sub = _check_substeps(stepper, n_steps, drift_every, track_drift)
    _check_obs_every(observable, obs_every, sub)
    dt = _dt_scalar(dt, phase0)
    measure_h, h0, h_scale, drift = _drift_setup(
        system, phase0, drift_dtype, track_drift
    )
    body = _final_loop_body(
        stepper, dt, measure_h, h0, h_scale, drift_every, track_drift,
        observable=observable, obs_every=obs_every,
    )
    obs = observable.init(phase0) if observable is not None else 0
    return stepper, body, (stepper.init(phase0), drift, obs), n_steps // sub


def evolve_ensemble_chunked(
    system: System,
    phase0: Phase,
    dt: float,
    n_steps: int,
    *,
    chunk_steps: int,
    method: str = "gauss4",
    iters=6,
    omega: float = 20.0,
    track_drift: bool = True,
    drift_every: int = 100,
    compensated: bool = False,
    drift_dtype=None,
    callback=None,
    steps_per_call: int = 1,
    carry_callback=None,
    initial_carry=None,
    initial_drift: Optional[torch.Tensor] = None,
    observable=None,
    obs_every: Optional[int] = None,
    initial_obs=None,
):
    """Like :func:`evolve_ensemble_final`, with the horizon cut into
    ``n_steps // chunk_steps`` chunks and a host hook after each.

    The integrator carry — the Kahan residuals, the warm starts and any
    cached factor — crosses chunk boundaries intact, so the result is the
    one-loop driver's.  ``callback(chunk_index, phase, drift)`` runs after
    each chunk, once the chunk's device work has finished.  ``chunk_steps``
    must divide ``n_steps`` and be a multiple of ``drift_every``.

    **Exact resume:** ``carry_callback(chunk_index, carry, drift, obs)``
    receives the raw carry after each chunk (for the fused stepper under
    per-member params, ``(state, table)``) and the streaming-observable
    state (0 without an observable; a three-argument callback gets the first
    three); ``initial_carry``/``initial_drift``/``initial_obs`` restart from
    one, and the continuation, the observable's accumulator included, is
    bitwise identical to the uninterrupted run.  ``phase0`` stays the
    original run's initial phase (it defines H₀).  ``observable`` and
    ``obs_every`` as in :func:`evolve_ensemble_final`; ``obs_every`` must
    divide ``chunk_steps``.
    """
    if n_steps % chunk_steps != 0:
        raise ValueError(f"{n_steps=} not divisible by {chunk_steps=}")
    if track_drift and chunk_steps % drift_every != 0:
        raise ValueError(f"{chunk_steps=} not divisible by {drift_every=}")
    stepper = make_stepper(
        system, method, iters=iters, omega=omega, compensated=compensated,
        steps_per_call=steps_per_call,
    )
    sub = _check_substeps(stepper, chunk_steps, drift_every, track_drift)
    _check_obs_every(observable, obs_every, sub)
    if observable is not None and chunk_steps % obs_every != 0:
        raise ValueError(
            f"{chunk_steps=} not divisible by {obs_every=} (observable sampling "
            f"must stay globally aligned across chunks)"
        )
    dt = _dt_scalar(dt, phase0)
    measure_h, h0, h_scale, drift = _drift_setup(
        system, phase0, drift_dtype, track_drift
    )
    # chunk boundaries are multiples of chunk_steps, which drift_every and
    # obs_every divide, so one body with offset 0 samples at the global
    # cadence
    body = _final_loop_body(
        stepper, dt, measure_h, h0, h_scale, drift_every, track_drift,
        observable=observable, obs_every=obs_every,
    )
    carry = stepper.init(phase0) if initial_carry is None else initial_carry
    if track_drift and initial_drift is not None:
        drift = initial_drift
    if initial_obs is not None:
        obs = initial_obs
    else:
        obs = observable.init(phase0) if observable is not None else 0
    wants_obs = carry_callback is not None and _callback_wants_obs(carry_callback)
    for ci in range(n_steps // chunk_steps):
        for i in range(chunk_steps // sub):
            carry, drift, obs = body(i, (carry, drift, obs))
        if callback is not None or carry_callback is not None:
            _sync(phase0.q)
        if callback is not None:
            callback(ci, stepper.extract(carry), drift)
        if carry_callback is not None:
            if wants_obs:
                carry_callback(ci, carry, drift, obs)
            else:
                carry_callback(ci, carry, drift)
    if observable is not None:
        return stepper.extract(carry), drift, obs
    return stepper.extract(carry), drift


def _on(device: torch.device):
    """The block's kernels launch on ``device``: its CUDA context, or
    nothing to do on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _shard_system(system: System, sl: slice, device: torch.device) -> System:
    """The system of the members ``sl`` on ``device``: batched params split
    with the members, everything else (the inertia) replicated."""
    pb = system.param_batch_ndim()
    if pb > 1:
        raise ValueError(f"sharded parameter sweeps support one params batch axis, got {pb}")
    if system.member_batch_ndim() > pb:
        raise ValueError("a per-member inertia (System.replace_inertia) is not sharded; "
                         "sweep the params, or use evolve_ensemble(system_batched=True)")
    local = system.to(device=device)
    if pb == 1:
        local = local.replace_params({k: v[sl] for k, v in local.params.items()})
    return local


def _combine(parts, spec, device, what):
    """One observable state from the shards' ``parts`` (dicts of tensors,
    nested or not): a leaf whose ``spec`` names a mesh axis is per-member,
    the shards' leaves concatenated; a leaf whose spec is None must agree on
    every shard and is taken once."""
    if isinstance(parts[0], dict):
        return {k: _combine([p[k] for p in parts], spec[k] if isinstance(spec, dict) else spec,
                            device, f"{what}[{k!r}]") for k in parts[0]}
    leaves = [torch.as_tensor(p).to(device) for p in parts]
    if spec is None:
        if not all(torch.equal(leaves[0], x) for x in leaves[1:]):
            raise ValueError(f"observable state {what} differs between shards; its "
                             f"shard_specs replicate it")
        return leaves[0]
    return torch.cat(leaves, dim=0)


def _reduce(value: torch.Tensor, op) -> torch.Tensor:
    """``all_reduce`` a scalar across the processes of the open process
    group (outside one, the value itself): on the current card under NCCL,
    on the CPU under gloo."""
    if not (dist.is_available() and dist.is_initialized()):
        return value
    at = (torch.device("cuda", torch.cuda.current_device())
          if dist.get_backend() == "nccl" else torch.device("cpu"))
    buf = value.to(at).clone()
    dist.all_reduce(buf, op=op)
    return buf.to(value.device)


def evolve_ensemble_sharded(
    system: System,
    phase0,
    dt: float,
    n_steps: int,
    *,
    mesh: EnsembleMesh,
    axis: str = "ensemble",
    method: str = "gauss4",
    emit_every: Optional[int] = None,
    iters=6,
    omega: float = 20.0,
    track_drift: bool = True,
    drift_every: int = 100,
    reduce_stats: Optional[str] = None,
    compensated: bool = False,
    steps_per_call: int = 1,
    group_unroll: int = 1,
    observable=None,
    obs_every: Optional[int] = None,
    drift_dtype=None,
):
    """Evolve the members split over ``mesh`` axis ``axis``.

    ``phase0`` (a ``(B, n)`` :class:`Phase`, or the shards of
    :func:`~hamilton_tpu_torch.parallel.shard_phase`) holds this process's
    members: the whole batch in one process, its
    :func:`~hamilton_tpu_torch.parallel.local_batch_slice` in a process
    group with a global mesh.  They split into equal contiguous blocks, one
    per shard of the axis that this process drives (the device at index 0
    of the other axes); the batch must divide.  Each shard runs
    :func:`evolve_ensemble_final`'s loop on its device with its own
    stepper: every loop iteration issues each shard's launches in turn, and
    nothing in the loop reads back to the host, so shards on different
    cards run at once (shards on one card queue on its stream).  Nothing in
    the loop crosses shards or processes.

    Returns ``(final, drift)`` as :func:`evolve_ensemble_final` does,
    gathered onto ``phase0``'s device (the first shard's): ``drift``
    per-member, or with ``reduce_stats`` ``"max"``/``"mean"`` a 0-d tensor
    reduced over the shards (the mean of the shards' means) and then with
    one ``all_reduce`` across the processes.  With ``emit_every``, the
    gathered ``(time, batch, n)`` trajectory of :func:`evolve_ensemble`,
    the shards run one after another.  With ``observable`` also its state:
    per-member leaves concatenated, a leaf that ``observable.shard_specs
    (axis)`` maps to None taken once (the shards must agree).

    Batched params (one leading batch axis, :meth:`System.replace_params`)
    split with their members; the inertia is replicated.  ``group_unroll``
    belongs to the TPU kernel's tiling and must be 1; ``drift_dtype`` is
    :func:`evolve_ensemble_final`'s."""
    if reduce_stats not in (None, "max", "mean"):
        raise ValueError(f"unknown {reduce_stats=}; use 'max' or 'mean'")
    if group_unroll != 1:
        raise ValueError(
            f"group_unroll={group_unroll}: the port's kernel takes any batch, "
            f"one thread a member; only 1 is accepted"
        )
    n_shards = mesh.shape[axis]
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    plan = [(k, d) for k, (d, r) in enumerate(mesh.axis_devices(axis)) if r == rank]
    if not plan:
        raise ValueError(f"the mesh's {axis!r} axis has no device of this process (rank {rank})")
    if isinstance(phase0, ShardedPhase):
        shards = list(phase0.shards)
        if len(phase0.grid) != 1 or list(phase0.devices) != [d for _, d in plan]:
            phase0 = phase0.gather()
            shards = None
        else:
            phase0 = shards[0]
    else:
        shards = None
    device = phase0.q.device
    batch = (sum(s.q.shape[0] for s in shards) if shards is not None
             else phase0.q.shape[0])
    if batch % len(plan) != 0:
        raise ValueError(f"batch {batch} not divisible by mesh axis {axis}={len(plan)}"
                         + (f" (this process's shards of {n_shards})"
                            if len(plan) != n_shards else ""))
    per = batch // len(plan)
    locals_ = []
    for i, (_, dev) in enumerate(plan):
        sl = slice(i * per, (i + 1) * per)
        ph = shards[i] if shards is not None else Phase(
            phase0.q[sl].to(dev).contiguous(), phase0.p[sl].to(dev).contiguous())
        locals_.append((dev, _shard_system(system, sl, dev), ph))

    if emit_every is not None:
        trajs = []
        for dev, sys_k, ph_k in locals_:
            with _on(dev):
                trajs.append(evolve_ensemble(
                    sys_k, ph_k, dt, n_steps, method=method, emit_every=emit_every,
                    iters=iters, omega=omega, compensated=compensated,
                    steps_per_call=steps_per_call,
                ))
        return Phase(torch.cat([t.q.to(device) for t in trajs], dim=1),
                     torch.cat([t.p.to(device) for t in trajs], dim=1))

    runs = []
    for dev, sys_k, ph_k in locals_:
        with _on(dev):
            runs.append(list(_final_setup(
                sys_k, ph_k, dt, n_steps, method=method, iters=iters, omega=omega,
                track_drift=track_drift, drift_every=drift_every, compensated=compensated,
                drift_dtype=drift_dtype, steps_per_call=steps_per_call,
                observable=observable, obs_every=obs_every,
            )) + [dev])
    for i in range(runs[0][3]):
        for run in runs:
            with _on(run[4]):
                run[2] = run[1](i, run[2])

    finals, drifts, obs_parts = [], [], []
    for stepper, _, (carry, drift, obs), _, dev in runs:
        with _on(dev):
            finals.append(stepper.extract(carry))
        drifts.append(drift)
        obs_parts.append(obs)
    final = Phase(torch.cat([f.q.to(device) for f in finals]),
                  torch.cat([f.p.to(device) for f in finals]))
    if track_drift:
        if reduce_stats == "max":
            drift = _reduce(torch.stack([d.max().to(device) for d in drifts]).max(),
                            dist.ReduceOp.MAX)
        elif reduce_stats == "mean":
            total = _reduce(torch.stack([d.mean().to(device) for d in drifts]).sum(),
                            dist.ReduceOp.SUM)
            drift = total / n_shards
        else:
            drift = torch.cat([d.to(device) for d in drifts])
    else:
        drift = None
    if observable is None:
        return final, drift
    spec = observable.shard_specs(axis) if hasattr(observable, "shard_specs") else axis
    return final, drift, _combine(obs_parts, spec, device, "")
