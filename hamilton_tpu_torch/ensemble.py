"""Ensemble evolution to the final state, with running energy-drift tracking.

PyTorch counterpart of the final-state drivers of :mod:`hamilton_tpu.ensemble`
(``evolve_ensemble_final`` and ``evolve_ensemble_chunked``).  The ensemble is
one batch-native ``(B, n)`` phase; the drivers run an eager Python loop of
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
stepper carry.  Not ported yet: the trajectory-emitting ``evolve_ensemble``
(M11) and ``evolve_ensemble_sharded`` (M13).
"""

from __future__ import annotations

import inspect
from typing import Optional

import torch

from hamilton_tpu_torch.integrators.fixed import make_stepper
from hamilton_tpu_torch.mechanics import hamiltonian
from hamilton_tpu_torch.state import Phase
from hamilton_tpu_torch.system import System

__all__ = ["evolve_ensemble_final", "evolve_ensemble_chunked"]


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
    if n_steps % drift_every != 0:
        raise ValueError(f"{n_steps=} not divisible by {drift_every=}")
    stepper = make_stepper(
        system, method, iters=iters, compensated=compensated,
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
    state = (stepper.init(phase0), drift, obs)
    for i in range(n_steps // sub):
        state = body(i, state)
    carry, drift, obs = state
    if observable is not None:
        return stepper.extract(carry), drift, obs
    return stepper.extract(carry), drift


def evolve_ensemble_chunked(
    system: System,
    phase0: Phase,
    dt: float,
    n_steps: int,
    *,
    chunk_steps: int,
    method: str = "gauss4",
    iters=6,
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
        system, method, iters=iters, compensated=compensated,
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
