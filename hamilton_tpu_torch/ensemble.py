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

Not ported yet: ``observable=`` streaming reductions (ROADMAP M12), the
trajectory-emitting ``evolve_ensemble`` (M11) and ``evolve_ensemble_sharded``
(M13).
"""

from __future__ import annotations

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
                     track_drift, step_offset=0):
    """The hot-loop body shared by both drivers: iteration ``i`` advances
    ``stepper.substeps`` dt-steps and, when the global dt-step index is a
    multiple of ``drift_every``, folds the sampled drift into the running
    maximum.  ``state`` is ``(carry, drift)``."""
    sub = stepper.substeps

    def body(i, state):
        carry, drift = state
        carry = stepper.step(carry, dt)
        step = step_offset + (i + 1) * sub
        if track_drift and step % drift_every == 0:
            h = measure_h(stepper.extract(carry))
            drift = torch.maximum(drift, torch.abs(h - h0) / h_scale)
        return carry, drift

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


def _check_unported(observable):
    if observable is not None:
        raise NotImplementedError(
            "observable= streaming reductions are not ported yet (ROADMAP M12)"
        )


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
):
    """Evolve a ``(B, n)`` batch to its final state without materializing
    trajectories.

    Returns ``(final_phase, max_drift)``: ``max_drift`` is the running
    per-member maximum of ``|H(t) − H(0)| / max(|H(0)|, 1)`` sampled every
    ``drift_every`` dt-steps, or None when ``track_drift=False`` (which
    evaluates no Hamiltonian).  See :func:`_drift_measure` for
    ``drift_dtype``.
    """
    _check_unported(observable)
    if n_steps % drift_every != 0:
        raise ValueError(f"{n_steps=} not divisible by {drift_every=}")
    stepper = make_stepper(
        system, method, iters=iters, compensated=compensated,
        steps_per_call=steps_per_call,
    )
    sub = _check_substeps(stepper, n_steps, drift_every, track_drift)
    dt = _dt_scalar(dt, phase0)
    measure_h, h0, h_scale, drift = _drift_setup(
        system, phase0, drift_dtype, track_drift
    )
    body = _final_loop_body(
        stepper, dt, measure_h, h0, h_scale, drift_every, track_drift
    )
    state = (stepper.init(phase0), drift)
    for i in range(n_steps // sub):
        state = body(i, state)
    carry, drift = state
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
):
    """Like :func:`evolve_ensemble_final`, with the horizon cut into
    ``n_steps // chunk_steps`` chunks and a host hook after each.

    The integrator carry — the Kahan residuals, the warm starts and any
    cached factor — crosses chunk boundaries intact, so the result is the
    one-loop driver's.  ``callback(chunk_index, phase, drift)`` runs after
    each chunk, once the chunk's device work has finished.  ``chunk_steps``
    must divide ``n_steps`` and be a multiple of ``drift_every``.

    **Exact resume:** ``carry_callback(chunk_index, carry, drift)`` receives
    the raw carry after each chunk (for the fused stepper under per-member
    params, ``(state, table)``); ``initial_carry``/``initial_drift``
    restart from one, and the continuation is bitwise identical to the
    uninterrupted run.  ``phase0`` stays the original run's initial phase
    (it defines H₀).  The reference's fourth callback argument, the
    streaming-observable state, arrives with ``observable=`` (ROADMAP M12).
    """
    _check_unported(observable)
    if n_steps % chunk_steps != 0:
        raise ValueError(f"{n_steps=} not divisible by {chunk_steps=}")
    if track_drift and chunk_steps % drift_every != 0:
        raise ValueError(f"{chunk_steps=} not divisible by {drift_every=}")
    stepper = make_stepper(
        system, method, iters=iters, compensated=compensated,
        steps_per_call=steps_per_call,
    )
    sub = _check_substeps(stepper, chunk_steps, drift_every, track_drift)
    dt = _dt_scalar(dt, phase0)
    measure_h, h0, h_scale, drift = _drift_setup(
        system, phase0, drift_dtype, track_drift
    )
    # chunk boundaries are multiples of chunk_steps, which drift_every
    # divides, so one body with offset 0 samples at the global cadence
    body = _final_loop_body(
        stepper, dt, measure_h, h0, h_scale, drift_every, track_drift
    )
    carry = stepper.init(phase0) if initial_carry is None else initial_carry
    if track_drift and initial_drift is not None:
        drift = initial_drift
    for ci in range(n_steps // chunk_steps):
        for i in range(chunk_steps // sub):
            carry, drift = body(i, (carry, drift))
        if callback is not None or carry_callback is not None:
            _sync(phase0.q)
        if callback is not None:
            callback(ci, stepper.extract(carry), drift)
        if carry_callback is not None:
            carry_callback(ci, carry, drift)
    return stepper.extract(carry), drift
