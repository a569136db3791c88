"""Device meshes, ensemble shards and the multi-process runtime.

PyTorch counterpart of :mod:`hamilton_tpu.parallel`: scale comes from
splitting the **ensemble axis** over devices.  One process drives the
shards of its local devices (several shards may share a card, or the
CPU); ``torch.distributed`` joins processes and carries only the global
mesh and the ensemble statistics, so the hot loop has no collective.
:func:`dryrun_multichip` is the port's counterpart of the reference's
multichip dry run (``__graft_entry__.py``).
"""

from hamilton_tpu_torch.parallel.mesh import (
    EnsembleMesh,
    ShardedPhase,
    ensemble_mesh,
    ensemble_sharding,
    replicated_sharding,
    shard_phase,
)
from hamilton_tpu_torch.parallel.distributed import (
    global_ensemble_mesh,
    init_distributed,
    is_distributed,
    local_batch_slice,
)

__all__ = [
    "ensemble_mesh",
    "ensemble_sharding",
    "replicated_sharding",
    "shard_phase",
    "init_distributed",
    "is_distributed",
    "global_ensemble_mesh",
    "local_batch_slice",
    "EnsembleMesh",
    "ShardedPhase",
    "dryrun_multichip",
]


def dryrun_multichip(n_devices: int) -> dict:
    """Run the sharded path once on tiny shapes over an ``n_devices`` mesh:
    the port's counterpart of the reference's multichip dry run.

    The mesh spans the first ``n_devices`` cards, or ``n_devices`` shards on
    the CPU when the process sees fewer cards; it is 2-D (ensemble × param,
    param 2) when ``n_devices`` is even.  A 4-link semiseparable chain,
    ``4 · n_devices`` members, takes 4 ``gauss4`` steps (iters 3) through
    :func:`~hamilton_tpu_torch.ensemble.evolve_ensemble_sharded`, then again
    as interleaved Benettin pairs with ``LyapunovPairs`` renormalizing every
    2 steps under the mesh.  Raises if a result is not finite or not of its
    shape; returns ``{"devices": [...], "mesh": {...}, "max_drift": x}``."""
    import torch

    from hamilton_tpu_torch.ensemble import evolve_ensemble_sharded
    from hamilton_tpu_torch.models import chain
    from hamilton_tpu_torch.state import Phase
    from hamilton_tpu_torch.utils.observables import LyapunovPairs

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devices = ([torch.device("cuda", i) for i in range(n_devices)] if cards >= n_devices
               else [torch.device("cpu")] * n_devices)
    param = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = ensemble_mesh(devices, param_axis=param)
    ex = chain(n_links=4, fused_solver="semiseparable", device=devices[0],
               dtype=torch.float64)
    batch = 4 * n_devices
    ph0 = ex.init_phase
    phase = Phase(ph0.q.expand(batch, 4).contiguous(), ph0.p.expand(batch, 4).contiguous())

    final, drift = evolve_ensemble_sharded(
        ex.system, shard_phase(phase, mesh), 1e-3, 4, mesh=mesh, axis="ensemble",
        method="gauss4", iters=3, drift_every=4,
    )
    if tuple(final.q.shape) != (batch, 4):
        raise AssertionError(f"sharded final state of shape {tuple(final.q.shape)}")
    max_drift = float(drift.max())
    if not (torch.isfinite(final.q).all() and torch.isfinite(drift).all()):
        raise AssertionError("sharded run not finite")

    lp = LyapunovPairs(d0=1e-6)
    paired = LyapunovPairs.pair_ensemble(phase, 1e-6)
    _, _, obs = evolve_ensemble_sharded(
        ex.system, paired, 1e-3, 4, mesh=mesh, axis="ensemble", method="gauss4", iters=3,
        drift_every=4, observable=lp, obs_every=2,
    )
    if tuple(obs["sum_log"].shape) != (batch,) or not torch.isfinite(obs["sum_log"]).all():
        raise AssertionError("the sharded LyapunovPairs state is not finite per pair")
    if int(obs["n_renorms"]) != 2:
        raise AssertionError(f"{int(obs['n_renorms'])} renormalizations, expected 2")
    return {"devices": [str(d) for d in devices], "mesh": dict(mesh.shape),
            "max_drift": max_drift}
