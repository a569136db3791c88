"""The port's sharded ensemble (``hamilton_tpu_torch.parallel``,
``evolve_ensemble_sharded``) against the JAX package's, on the CPU.

The port's side of ``tests/test_ensemble.py``'s ``TestSharded``,
``Test2DBatchGrid``, ``TestDistributedHooks`` and
``TestStreamingObservables::test_sharded_matches_unsharded``.  The reference
shards over the conftest's 8 virtual CPU devices (``devices8``); the port
over 8 shards on the CPU (a mesh may repeat a device).  Inputs are made with
numpy from a seed and handed to both packages; float64, 1e-12.  The
checkpoint round trip, the multichip dry run and the process-group hooks of
one process are here too; ``test_torch_distributed.py`` runs two.
"""

import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamilton_tpu import Phase as JPhase
from hamilton_tpu import evolve_ensemble_sharded as j_sharded
from hamilton_tpu.ensemble import evolve_ensemble_final as j_final
from hamilton_tpu.models import double_pendulum as j_double_pendulum
from hamilton_tpu.parallel import ensemble_mesh as j_mesh
from hamilton_tpu.utils import LyapunovPairs as JLyapunovPairs

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import parallel
from hamilton_tpu_torch.convert import params_from_numpy, phase_from_numpy
from hamilton_tpu_torch.utils import LyapunovPairs, load_orbax, save_orbax

F64 = torch.float64
CPU8 = ["cpu"] * 8
TOL = 1e-12


def _batch(b, seed=0):
    """``b`` double-pendulum members: the initial phase with θ₁ jittered."""
    rng = np.random.default_rng(seed)
    q = np.array([np.pi / 2, np.pi / 2]) + 0.01 * rng.standard_normal((b, 2)) * [1.0, 0.0]
    p = 0.01 * rng.standard_normal((b, 2))
    return q, p


def _both(q, p):
    return JPhase(jnp.asarray(q), jnp.asarray(p)), phase_from_numpy(q, p, device="cpu",
                                                                      dtype=F64)


def _close(want, got, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def _port_dp():
    return tp.double_pendulum(device="cpu", dtype=F64)


#: the horizon of every comparison: 4 gauss4 steps, drift every 2 (the
#: port's eager gauss4 takes ~80 ms a step on the CPU, each shard its own)
STEPS, DRIFT_EVERY = 4, 2


def test_sharded_matches_the_reference(devices8):
    """16 members over 8 shards: the final state and the per-member drift
    as the reference's ``shard_map`` over 8 devices gives them, and the
    unsharded driver's bit for bit (each member's arithmetic is its own);
    ``reduce_stats`` "max" and "mean" as the max and the mean of the
    reference's per-member drift."""
    jph, tph = _both(*_batch(16))
    want_final, want_drift = j_sharded(j_double_pendulum().system, jph, 0.01, STEPS,
                                       mesh=j_mesh(devices8), drift_every=DRIFT_EVERY)
    mesh = parallel.ensemble_mesh(CPU8)
    final, drift = tp.evolve_ensemble_sharded(_port_dp().system, tph, 0.01, STEPS, mesh=mesh,
                                              drift_every=DRIFT_EVERY)
    _close(want_final.q, final.q)
    _close(want_final.p, final.p)
    assert tuple(drift.shape) == (16,)
    _close(want_drift, drift, 1e-15)
    one = tp.evolve_ensemble_final(_port_dp().system, tph, 0.01, STEPS, drift_every=DRIFT_EVERY)
    assert torch.equal(one[0].q, final.q) and torch.equal(one[0].p, final.p)
    assert torch.equal(one[1], drift)
    for stat, fn in (("max", np.max), ("mean", np.mean)):
        _, got = tp.evolve_ensemble_sharded(_port_dp().system, tph, 0.01, STEPS, mesh=mesh,
                                            drift_every=DRIFT_EVERY, reduce_stats=stat)
        assert got.ndim == 0
        _close(fn(np.asarray(want_drift)), got, 1e-15)


def test_sharded_trajectory():
    """``emit_every``: the gathered ``(time, batch, n)`` trajectory, the
    unsharded ``evolve_ensemble``'s bit for bit."""
    _, tph = _both(*_batch(8, seed=4))
    traj = tp.evolve_ensemble_sharded(_port_dp().system, tph, 0.01, STEPS, emit_every=2,
                                      mesh=parallel.ensemble_mesh(CPU8))
    assert tuple(traj.q.shape) == (3, 8, 2)
    one = tp.evolve_ensemble(_port_dp().system, tph, 0.01, STEPS, emit_every=2)
    assert torch.equal(traj.q, one.q) and torch.equal(traj.p, one.p)


def test_sharded_params_sweep_matches_the_reference(devices8):
    """Batched params split with their members over the mesh axis."""
    b = 16
    m2 = np.linspace(0.5, 2.0, b)
    jsys = j_double_pendulum().system.replace_params({"m1": jnp.ones(b), "m2": jnp.asarray(m2)})
    tsys = _port_dp().system.replace_params(params_from_numpy(
        {"m1": np.ones(b), "m2": m2}, device="cpu", dtype=F64))
    jph, tph = _both(*_batch(b, seed=1))
    want = j_sharded(jsys, jph, 0.01, STEPS, mesh=j_mesh(devices8), drift_every=DRIFT_EVERY)
    got = tp.evolve_ensemble_sharded(tsys, tph, 0.01, STEPS, mesh=parallel.ensemble_mesh(CPU8),
                                     drift_every=DRIFT_EVERY)
    _close(want[0].q, got[0].q)
    _close(want[1], got[1], 1e-15)
    unsharded = tp.evolve_ensemble_final(tsys, tph, 0.01, STEPS, drift_every=DRIFT_EVERY)
    assert torch.equal(unsharded[0].q, got[0].q) and torch.equal(unsharded[1], got[1])


def test_bad_batch_divisibility_and_mesh_errors():
    _, tph = _both(*_batch(12))
    with pytest.raises(ValueError, match="not divisible"):
        tp.evolve_ensemble_sharded(_port_dp().system, tph, 0.01, 10,
                                   mesh=parallel.ensemble_mesh(CPU8))
    with pytest.raises(ValueError, match="reduce_stats"):
        tp.evolve_ensemble_sharded(_port_dp().system, tph, 0.01, 10,
                                   mesh=parallel.ensemble_mesh(["cpu"] * 4), reduce_stats="sum")
    with pytest.raises(ValueError, match="divisible"):
        parallel.ensemble_mesh(["cpu"] * 6, param_axis=4)
    if not torch.cuda.is_available():
        # no card and no device list: the mesh says so, and never falls back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.ensemble_mesh()


def test_2d_param_mesh(devices8):
    """A 4 × 2 ensemble × param mesh: its axes as the reference's; the
    ensemble axis splits the batch into 4 (the param axis replicated), from
    shards made by ``shard_phase`` over all 8 (gathered and split again)."""
    mesh = parallel.ensemble_mesh(CPU8, param_axis=2)
    assert mesh.shape == {"ensemble": 4, "param": 2} == dict(j_mesh(devices8, param_axis=2).shape)
    assert parallel.ensemble_sharding(mesh).spec == (("ensemble", "param"),)
    assert parallel.ensemble_sharding(mesh, batch_ndim=2).spec == (("ensemble",), ("param",))
    assert parallel.replicated_sharding(mesh).spec == ()
    _, tph = _both(*_batch(8, seed=2))
    shards = parallel.shard_phase(tph, mesh)
    assert shards.grid == (8,) and torch.equal(shards.gather().p, tph.p)
    got = tp.evolve_ensemble_sharded(_port_dp().system, shards, 0.01, STEPS, mesh=mesh,
                                     drift_every=DRIFT_EVERY)
    one = tp.evolve_ensemble_final(_port_dp().system, tph, 0.01, STEPS, drift_every=DRIFT_EVERY)
    assert torch.equal(one[0].q, got[0].q) and torch.equal(one[1], got[1])


def test_2d_ic_param_grid(devices8):
    """A 2-D batch grid (IC sweep × momentum sweep) split over the 4 × 2
    mesh: each of the 8 shards (2 × 2 members) runs on its own, and the
    gathered grid equals the reference's GSPMD run of the whole grid."""
    b1, b2 = 8, 4
    dp = _port_dp()
    base_q, base_p = dp.init_phase.q.numpy(), dp.init_phase.p.numpy()
    dq = np.linspace(-0.01, 0.01, b1)[:, None, None] * np.array([1.0, 0.0])
    dpp = np.linspace(0.0, 0.05, b2)[None, :, None] * np.array([0.0, 1.0])
    q = np.broadcast_to(base_q, (b1, b2, 2)) + dq
    p = np.broadcast_to(base_p, (b1, b2, 2)) + dpp
    jph, tph = _both(q, p)
    want, want_drift = jax.jit(lambda ph: j_final(
        j_double_pendulum().system, ph, 0.01, STEPS, method="gauss4",
        drift_every=DRIFT_EVERY))(jph)
    mesh = parallel.ensemble_mesh(CPU8, param_axis=2)
    sharded = parallel.shard_phase(tph, mesh, batch_ndim=2)
    assert sharded.grid == (4, 2) and all(tuple(s.q.shape) == (2, 2, 2) for s in sharded.shards)
    assert torch.equal(sharded.gather().q, tph.q)
    outs = [tp.evolve_ensemble_final(dp.system, s, 0.01, STEPS, drift_every=DRIFT_EVERY)
            for s in sharded.shards]
    final = parallel.ShardedPhase(tuple(o[0] for o in outs), sharded.grid,
                                  sharded.devices).gather()
    assert tuple(final.q.shape) == (b1, b2, 2)
    _close(want.q, final.q)
    _close(want.p, final.p)
    assert float(torch.cat([o[1].reshape(-1) for o in outs]).max()) < 1e-6
    _close(np.max(np.asarray(want_drift)), max(float(o[1].max()) for o in outs), 1e-15)


def test_sharded_lyapunov_matches_the_reference(devices8):
    """Interleaved Benettin pairs over 8 shards (each shard an even number
    of members, so pairs stay together), renormalized every 2 steps: the
    per-pair log-growth is concatenated and the renormalization count
    (replicated by ``shard_specs``) taken once, both as the reference's
    and as the unsharded driver's bit for bit.  ``log(d/d0)`` carries the
    states' rounding amplified by 1/d0: at d0 = 1e-4 ~1e-12."""
    rng = np.random.default_rng(5)
    q0 = np.stack([0.05 + 0.001 * rng.standard_normal(16), 0.001 * rng.standard_normal(16)], 1)
    jph, tph = _both(q0, np.zeros((16, 2)))
    d0 = 1e-4
    jpairs = JLyapunovPairs.pair_ensemble(jph, d0)
    tpairs = LyapunovPairs.pair_ensemble(tph, d0)
    assert LyapunovPairs().shard_specs("ensemble") == {"sum_log": "ensemble", "n_renorms": None}
    kw = dict(method="gauss4", iters=6, drift_every=DRIFT_EVERY, obs_every=2)
    _, _, want = j_sharded(j_double_pendulum().system, jpairs, 5e-3, STEPS,
                           mesh=j_mesh(devices8), observable=JLyapunovPairs(d0=d0), **kw)
    _, _, got = tp.evolve_ensemble_sharded(_port_dp().system, tpairs, 5e-3, STEPS,
                                           mesh=parallel.ensemble_mesh(CPU8),
                                           observable=LyapunovPairs(d0=d0), **kw)
    assert tuple(got["sum_log"].shape) == (16,)
    _close(want["sum_log"], got["sum_log"])
    assert int(got["n_renorms"]) == int(want["n_renorms"]) == STEPS // 2
    _, _, one = tp.evolve_ensemble_final(_port_dp().system, tpairs, 5e-3, STEPS,
                                         observable=LyapunovPairs(d0=d0), **kw)
    assert torch.equal(one["sum_log"], got["sum_log"])


def test_init_distributed_single_process_is_noop():
    assert parallel.init_distributed() is False
    assert not parallel.is_distributed()


def test_init_distributed_explicit_bad_coordinator_raises():
    """Explicit arguments that cannot form the group (rank 0 of 2, and no
    rank 1 ever comes) raise within the timeout given."""
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        parallel.init_distributed(coordinator_address="127.0.0.1:1", num_processes=2,
                                  process_id=0, backend="gloo", timeout=2)
    assert time.perf_counter() - t0 < 60
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="together"):
        parallel.init_distributed(coordinator_address="127.0.0.1:1")


def test_global_mesh_and_local_slice():
    mesh = parallel.global_ensemble_mesh(param_axis=2, devices=CPU8)
    assert mesh.shape["ensemble"] * mesh.shape["param"] == 8
    assert set(mesh.ranks.flat) == {0}
    sl = parallel.local_batch_slice(64)
    assert (sl.start, sl.stop) == (0, 64)


def test_checkpoint_round_trip_of_the_shards(tmp_path):
    """``save_orbax``/``load_orbax`` (DCP files): the sharded final state
    back onto its shards bit for bit, a bare Phase, and a nested state with
    a bfloat16 leaf (which ``.npz`` refuses)."""
    _, tph = _both(*_batch(16, seed=3))
    mesh = parallel.ensemble_mesh(["cpu"] * 4)
    final, _ = tp.evolve_ensemble_sharded(_port_dp().system, tph, 0.01, STEPS, mesh=mesh,
                                          drift_every=DRIFT_EVERY)
    shards = parallel.shard_phase(final, mesh)
    save_orbax(str(tmp_path / "shards"), shards)
    back = load_orbax(str(tmp_path / "shards"), like=shards)
    assert isinstance(back, parallel.ShardedPhase)
    assert all(torch.equal(a.q, b.q) and torch.equal(a.p, b.p)
               for a, b in zip(shards.shards, back.shards))
    save_orbax(str(tmp_path / "phase"), final)
    bare = load_orbax(str(tmp_path / "phase"), device="cpu")
    assert isinstance(bare, tp.Phase) and torch.equal(bare.q, final.q)
    state = {"carry": (final.q, final.p), "obs": {"x": torch.arange(4, dtype=torch.bfloat16)}}
    save_orbax(str(tmp_path / "tree"), state)
    like = {"carry": (torch.zeros(16, 2, dtype=F64), torch.zeros(16, 2, dtype=F64)),
            "obs": {"x": torch.zeros(4, dtype=torch.bfloat16)}}
    tree = load_orbax(str(tmp_path / "tree"), like=like)
    assert torch.equal(tree["carry"][1], final.p) and torch.equal(tree["obs"]["x"],
                                                                  state["obs"]["x"])


def test_dryrun_multichip_on_cpu_shards():
    """Fewer than 8 cards: the dry run's 4 × 2 mesh of CPU shards, gauss4 and
    ``LyapunovPairs`` under it."""
    out = parallel.dryrun_multichip(8)
    assert out["mesh"] == {"ensemble": 4, "param": 2}
    if torch.cuda.device_count() < 8:
        assert out["devices"] == ["cpu"] * 8
    assert out["max_drift"] < 1e-6
