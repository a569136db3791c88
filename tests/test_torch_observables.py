"""The port's observables (``hamilton_tpu_torch/utils/observables.py``) and
the ensemble drivers' ``observable=`` streaming, against the JAX package on
the CPU.

The same inputs, made with numpy from a seed, go through both packages in
float64 on the library leapfrog (3,2): the energies and drift to 1e-12,
the post-hoc Lyapunov slope to 1e-9 (a least-squares fit over logs), the
streaming states — running extrema, Benettin sums (a transforming
observable that re-inits the carry), Poincaré crossings — and the final
phases to 1e-12.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hamilton_tpu import models as jmodels
from hamilton_tpu.ensemble import evolve_ensemble_chunked as j_chunked
from hamilton_tpu.ensemble import evolve_ensemble_final as j_final
from hamilton_tpu.state import Phase as JPhase
from hamilton_tpu.utils import observables as jobs

import hamilton_tpu_torch as tp
from hamilton_tpu_torch.convert import phase_from_numpy
from hamilton_tpu_torch.utils import observables as tobs

F64 = torch.float64
TOL = 1e-12
RUN = dict(method="leapfrog", iters=(3, 2), drift_every=10)


def _systems():
    return (jmodels.double_pendulum().system,
            tp.double_pendulum(device="cpu", dtype=F64).system)


def _inputs(batch=8, seed=0):
    rng = np.random.default_rng(seed)
    q = np.array([1.2, 0.3]) + 0.05 * rng.standard_normal((batch, 2))
    p = 0.3 * rng.standard_normal((batch, 2))
    return q, p


def _phases(q, p):
    return JPhase(jnp.asarray(q), jnp.asarray(p)), phase_from_numpy(q, p, device="cpu",
                                                                    dtype=F64)


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=tol)


def test_energies_and_drift_match_the_reference():
    """KE, PE, H and max|ΔH/H₀| over a (time, batch, n) trajectory."""
    jsys, tsys = _systems()
    rng = np.random.default_rng(1)
    q = rng.standard_normal((5, 8, 2))
    p = rng.standard_normal((5, 8, 2))
    jph, tph = _phases(q, p)
    je, te = jobs.energies(jsys, jph), tobs.energies(tsys, tph)
    for key in ("ke", "pe", "h"):
        _close(je[key], te[key].numpy())
    _close(jobs.hamiltonian_trajectory(jsys, jph), tobs.hamiltonian_trajectory(tsys, tph))
    _close(jobs.energy_drift(jsys, jph), tobs.energy_drift(tsys, tph))


def test_lyapunov_estimate_matches_the_reference():
    rng = np.random.default_rng(2)
    qa, pa = rng.standard_normal((20, 6, 2)), rng.standard_normal((20, 6, 2))
    growth = np.exp(0.3 * np.arange(20))[:, None, None]
    qb, pb = qa + 1e-6 * growth * rng.standard_normal((20, 6, 2)), pa
    jsys, tsys = _systems()
    ja, ta = _phases(qa, pa)
    jb, tb = _phases(qb, pb)
    _close(jobs.lyapunov_estimate(jsys, ja, jb, 0.1),
           tobs.lyapunov_estimate(tsys, ta, tb, 0.1), 1e-9)


def test_running_extrema_through_the_final_driver():
    """Running min/max of |θ₁| every 5 steps over 40 steps, with the drift."""
    jsys, tsys = _systems()
    jph, tph = _phases(*_inputs())
    jfin, jd, jo = j_final(jsys, jph, 1e-2, 40, observable=jobs.RunningExtrema(
        lambda ph: jnp.abs(ph.q[..., 0])), obs_every=5, **RUN)
    tfin, td, to = tp.evolve_ensemble_final(tsys, tph, 1e-2, 40, observable=tobs.RunningExtrema(
        lambda ph: torch.abs(ph.q[..., 0])), obs_every=5, **RUN)
    for key in ("min", "max"):
        _close(jo[key], to[key].numpy())
    _close(jfin.q, tfin.q.numpy())
    _close(jd, td.numpy())
    assert float((to["max"] - to["min"]).min()) > 0


def test_lyapunov_pairs_transform_the_carry():
    """Benettin pairs: every 10 steps the perturbed members are pulled back
    to d0 and the carry re-inited from the returned phase; the log sums,
    the renormalization count and the final phase agree."""
    jsys, tsys = _systems()
    q, p = _inputs(batch=4, seed=3)
    jpair = jobs.LyapunovPairs.pair_ensemble(JPhase(jnp.asarray(q), jnp.asarray(p)), 1e-6)
    tpair = tobs.LyapunovPairs.pair_ensemble(phase_from_numpy(q, p, device="cpu", dtype=F64),
                                             1e-6)
    _close(jpair.q, tpair.q.numpy(), 0.0)
    jfin, _, jo = j_final(jsys, jpair, 1e-2, 60, observable=jobs.LyapunovPairs(1e-6),
                          obs_every=10, **RUN)
    tfin, _, to = tp.evolve_ensemble_final(tsys, tpair, 1e-2, 60,
                                           observable=tobs.LyapunovPairs(1e-6), obs_every=10,
                                           **RUN)
    assert int(to["n_renorms"]) == int(jo["n_renorms"]) == 6
    # log(d/d0) of a separation d ~ 1e-6 between states good to ~1e-15:
    # ~1e-9 relative a renormalization, six of them
    _close(jo["sum_log"], to["sum_log"].numpy(), 1e-8)
    _close(jfin.q, tfin.q.numpy())
    lam = tobs.LyapunovPairs(1e-6).lyapunov(to, 0.6)
    _close(jobs.LyapunovPairs(1e-6).lyapunov(jo, 0.6), lam.numpy(), 2e-8)
    with pytest.raises(ValueError, match="even"):
        tobs.LyapunovPairs().init(tp.Phase(tpair.q[:3], tpair.p[:3]))


def test_poincare_sections_through_the_final_driver():
    """Upward crossings of θ₂ = 0.3 every step over 400 steps into 2 slots
    (one member overflows): counts, overflows and the interpolated crossing
    states agree."""
    jsys, tsys = _systems()
    q, p = _inputs(batch=6, seed=4)
    jph, tph = _phases(q, p)
    _, _, jo = j_final(jsys, jph, 1e-2, 400, observable=jobs.PoincareSections(
        lambda ph: ph.q[..., 1] - 0.3, 2), obs_every=1, **RUN)
    _, _, to = tp.evolve_ensemble_final(tsys, tph, 1e-2, 400, observable=tobs.PoincareSections(
        lambda ph: ph.q[..., 1] - 0.3, 2), obs_every=1, **RUN)
    np.testing.assert_array_equal(np.asarray(jo["count"]), to["count"].numpy())
    np.testing.assert_array_equal(np.asarray(jo["overflow"]), to["overflow"].numpy())
    assert int(to["count"].sum()) > 0 and int(to["overflow"].sum()) > 0
    _close(jo["q"], to["q"].numpy(), 1e-10)
    _close(jo["p"], to["p"].numpy(), 1e-10)
    (jpts, jvalid), (tpts, tvalid) = (jobs.PoincareSections.points(jo),
                                     tobs.PoincareSections.points(to))
    np.testing.assert_array_equal(np.asarray(jvalid), tvalid.numpy())


def test_chunked_driver_streams_and_resumes():
    """The chunked driver with an observable: the same state as the
    reference's, the carry callback's fourth argument is the observable's
    state, a three-argument callback still gets three, and a restart from
    a saved carry, drift and observable state continues bitwise."""
    jsys, tsys = _systems()
    jph, tph = _phases(*_inputs(seed=5))
    run = dict(chunk_steps=20, obs_every=5, **RUN)
    jfin, _, jo = j_chunked(jsys, jph, 1e-2, 60, observable=jobs.RunningExtrema(
        lambda ph: ph.p[..., 0]), **run)
    obs = tobs.RunningExtrema(lambda ph: ph.p[..., 0])
    saved, three = {}, []

    def keep(ci, carry, drift, state):
        saved[ci] = (carry, drift.clone(), {k: v.clone() for k, v in state.items()})

    tfin, tdrift, to = tp.evolve_ensemble_chunked(tsys, tph, 1e-2, 60, observable=obs,
                                                  carry_callback=keep, **run)
    _close(jo["max"], to["max"].numpy())
    _close(jfin.p, tfin.p.numpy())
    assert sorted(saved) == [0, 1, 2]
    carry, drift, state = saved[0]
    rest, rdrift, ro = tp.evolve_ensemble_chunked(tsys, tph, 1e-2, 40, observable=obs,
                                                  initial_carry=carry, initial_drift=drift,
                                                  initial_obs=state, **run)
    assert torch.equal(rest.q, tfin.q) and torch.equal(rdrift, tdrift)
    assert torch.equal(ro["min"], to["min"]) and torch.equal(ro["max"], to["max"])
    tp.evolve_ensemble_chunked(tsys, tph, 1e-2, 20, carry_callback=lambda ci, c, d: three.append(ci),
                               **run)
    assert three == [0]


def test_observable_on_the_fused_stepper():
    """The fused stepper (5 steps a call) streams with obs_every a multiple
    of its substeps, and agrees with the library leapfrog at (3,2)."""
    _, tsys = _systems()
    _, tph = _phases(*_inputs(seed=6))
    obs = tobs.RunningExtrema(lambda ph: ph.q[..., 1])
    lib = tp.evolve_ensemble_final(tsys, tph, 1e-2, 40, observable=obs, obs_every=10, **RUN)
    fus = tp.evolve_ensemble_final(tsys, tph, 1e-2, 40, observable=obs, obs_every=10,
                                   method="leapfrog_fused", iters=(3, 2), steps_per_call=5,
                                   drift_every=10)
    _close(lib[2]["max"].numpy(), fus[2]["max"].numpy())
    _close(lib[0].q.numpy(), fus[0].q.numpy())


@pytest.mark.parametrize("driver", ["final", "chunked"])
def test_obs_every_errors(driver):
    """``obs_every`` is required with an observable and must be a multiple
    of the stepper's substeps; the chunked driver also needs it to divide
    ``chunk_steps``, as the reference's drivers require."""
    _, tsys = _systems()
    _, tph = _phases(*_inputs(batch=2))
    obs = tobs.RunningExtrema(lambda ph: ph.q[..., 0])
    fused = dict(method="leapfrog_fused", iters=(2, 1), steps_per_call=5, drift_every=10)
    run = (tp.evolve_ensemble_final if driver == "final"
           else lambda *a, **k: tp.evolve_ensemble_chunked(*a, chunk_steps=20, **k))
    with pytest.raises(ValueError, match="obs_every"):
        run(tsys, tph, 1e-2, 20, observable=obs, **RUN)
    with pytest.raises(ValueError, match=r"multiple of the stepper's substeps \(5\); got 3"):
        run(tsys, tph, 1e-2, 20, observable=obs, obs_every=3, **fused)
    if driver == "chunked":
        with pytest.raises(ValueError, match="not divisible by obs_every"):
            run(tsys, tph, 1e-2, 20, observable=obs, obs_every=15, **fused)
