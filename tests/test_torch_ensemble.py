"""The port's ensemble drivers (``hamilton_tpu_torch/ensemble.py``) against
the JAX package's, and their exact-resume contract.

The reference's chunked driver runs the fused kernel in interpret mode, as
its own tests do.  Both sides sample ``max|ΔH/H₀|`` with the library
Hamiltonian in float64; the trajectories agree to float64 rounding and the
drift to the rounding of two Hamiltonian evaluations (atol 1e-13).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hamilton_tpu import models as jmodels
from hamilton_tpu.ensemble import evolve_ensemble_chunked as j_chunked
from hamilton_tpu.state import Phase as JPhase

import hamilton_tpu_torch as tp
from hamilton_tpu_torch.convert import phase_from_numpy

F64 = torch.float64
B = 1024  # the reference's fused stepper takes batches of 1024·k
RUN = dict(method="leapfrog_fused", iters=(2, 0), compensated=True,
           drift_every=5, steps_per_call=5)


def _inputs(batch=B, seed=0):
    rng = np.random.default_rng(seed)
    q = 0.5 + 0.01 * rng.standard_normal((batch, 4))
    p = 0.05 * rng.standard_normal((batch, 4))
    return q, p


def _port_system():
    return tp.chain(n_links=4, fused_solver="semiseparable", device="cpu", dtype=F64).system


def test_chunked_matches_reference_driver():
    """chain-4 semiseparable, (2,0), Kahan, float64, spc=5: two chunks of
    10 steps with drift every 5, against the reference's driver."""
    q, p = _inputs()
    jsys = jmodels.chain(n_links=4, fused_solver="semiseparable").system
    with pltpu.force_tpu_interpret_mode():
        jfin, jdrift = j_chunked(jsys, JPhase(jnp.asarray(q), jnp.asarray(p)), 1e-3, 20,
                                 chunk_steps=10, drift_dtype=jnp.float64, **RUN)
        jax.block_until_ready(jfin.q)
    tfin, tdrift = tp.evolve_ensemble_chunked(
        _port_system(), phase_from_numpy(q, p, device="cpu", dtype=F64), 1e-3, 20,
        chunk_steps=10, drift_dtype=F64, **RUN,
    )
    np.testing.assert_allclose(np.asarray(jfin.q), tfin.q.numpy(), rtol=0, atol=1e-13)
    np.testing.assert_allclose(np.asarray(jfin.p), tfin.p.numpy(), rtol=0, atol=1e-13)
    assert tdrift.shape == (B,) and float(tdrift.max()) > 0.0
    np.testing.assert_allclose(np.asarray(jdrift), tdrift.numpy(), rtol=0, atol=1e-13)


def test_exact_resume_is_bitwise():
    """Restarting from the carry and drift a carry_callback saved continues
    bitwise like the uninterrupted run."""
    q, p = _inputs(batch=16)
    sys_ = _port_system()
    ph0 = phase_from_numpy(q, p, device="cpu", dtype=F64)
    saved, seen = {}, []

    def keep(ci, carry, drift):
        saved[ci] = (carry.clone(), drift.clone())

    def on_chunk(ci, phase, drift):
        seen.append((ci, tuple(phase.q.shape), tuple(drift.shape)))

    full, dfull = tp.evolve_ensemble_chunked(
        sys_, ph0, 1e-3, 30, chunk_steps=10, drift_dtype=F64,
        carry_callback=keep, callback=on_chunk, **RUN,
    )
    assert seen == [(ci, (16, 4), (16,)) for ci in range(3)]
    carry1, drift1 = saved[0]
    rest, drest = tp.evolve_ensemble_chunked(
        sys_, ph0, 1e-3, 20, chunk_steps=10, drift_dtype=F64,
        initial_carry=carry1, initial_drift=drift1, **RUN,
    )
    assert torch.equal(full.q, rest.q) and torch.equal(full.p, rest.p)
    assert torch.equal(dfull, drest)


def test_final_driver_equals_chunked():
    q, p = _inputs(batch=16, seed=1)
    sys_ = _port_system()
    ph0 = phase_from_numpy(q, p, device="cpu", dtype=F64)
    a, da = tp.evolve_ensemble_final(sys_, ph0, 1e-3, 20, **RUN)
    b, db = tp.evolve_ensemble_chunked(sys_, ph0, 1e-3, 20, chunk_steps=10, **RUN)
    assert torch.equal(a.q, b.q) and torch.equal(a.p, b.p) and torch.equal(da, db)
    c, dc = tp.evolve_ensemble_final(sys_, ph0, 1e-3, 20,
                                     **dict(RUN, compensated=False), track_drift=False)
    assert dc is None and bool(torch.isfinite(c.q).all())


def test_untracked_drift_evaluates_no_hamiltonian(monkeypatch):
    """With track_drift=False neither driver builds the drift sampler: the
    run never evaluates H, and the drift it returns is None."""
    q, p = _inputs(batch=16, seed=3)
    sys_ = _port_system()
    ph0 = phase_from_numpy(q, p, device="cpu", dtype=F64)
    want, _ = tp.evolve_ensemble_final(sys_, ph0, 1e-3, 20, **RUN)

    def no_h(*args, **kwargs):
        raise AssertionError("the drift sampler ran without drift tracking")

    monkeypatch.setattr("hamilton_tpu_torch.ensemble.hamiltonian", no_h)
    seen = []
    a, da = tp.evolve_ensemble_final(sys_, ph0, 1e-3, 20, **RUN, track_drift=False)
    b, db = tp.evolve_ensemble_chunked(
        sys_, ph0, 1e-3, 20, chunk_steps=10, **RUN, track_drift=False,
        callback=lambda ci, ph, d: seen.append(d),
    )
    assert da is None and db is None and seen == [None, None]
    for got in (a, b):
        assert torch.equal(got.q, want.q) and torch.equal(got.p, want.p)


def test_library_leapfrog_through_the_driver():
    """The same driver runs the library path (one dt-step per call)."""
    q, p = _inputs(batch=8, seed=2)
    sys_ = _port_system()
    ph0 = phase_from_numpy(q, p, device="cpu", dtype=F64)
    lib, dlib = tp.evolve_ensemble_final(sys_, ph0, 1e-3, 10, method="leapfrog",
                                         iters=(3, 2), drift_every=5)
    fus, dfus = tp.evolve_ensemble_final(sys_, ph0, 1e-3, 10, method="leapfrog_fused",
                                         iters=(3, 2), drift_every=5)
    np.testing.assert_allclose(lib.q.numpy(), fus.q.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(dlib.numpy(), dfus.numpy(), rtol=0, atol=1e-12)


def test_driver_argument_checks():
    q, p = _inputs(batch=4)
    sys_ = _port_system()
    ph0 = phase_from_numpy(q, p, device="cpu", dtype=F64)
    with pytest.raises(NotImplementedError, match="M7"):
        tp.evolve_ensemble_final(sys_, ph0, 1e-3, 10, drift_dtype="df32", **RUN)
    with pytest.raises(NotImplementedError, match="M12"):
        tp.evolve_ensemble_chunked(sys_, ph0, 1e-3, 10, chunk_steps=10,
                                   observable=object(), **RUN)
    with pytest.raises(ValueError, match="not divisible"):
        tp.evolve_ensemble_chunked(sys_, ph0, 1e-3, 25, chunk_steps=10, **RUN)
    with pytest.raises(ValueError, match="substeps"):
        tp.evolve_ensemble_final(sys_, ph0, 1e-3, 12, **dict(RUN, drift_every=4))
