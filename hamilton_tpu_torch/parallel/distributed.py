"""Multi-process runtime hooks.

PyTorch counterpart of :mod:`hamilton_tpu.parallel.distributed`.  One
process drives the shards of its local devices; ``torch.distributed``
joins the processes (NCCL between cards, gloo on the CPU) and carries only
what crosses them: the global mesh (each rank's device list, once) and the
ensemble statistics of :func:`~hamilton_tpu_torch.ensemble.
evolve_ensemble_sharded` (one ``all_reduce``).  The hot loop has no
collective.

* :func:`init_distributed` opens the process group from explicit arguments
  or a launcher's environment (``torchrun``'s ``MASTER_ADDR``, ...), and is
  a no-op without either;
* :func:`global_ensemble_mesh` is the ensemble×param mesh over every
  process's devices, in rank order;
* :func:`local_batch_slice` is this process's block of a global batch.

In one process, ``global_ensemble_mesh`` is :func:`~hamilton_tpu_torch.
parallel.ensemble_mesh` and ``local_batch_slice`` the whole batch.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hamilton_tpu_torch.parallel.mesh import EnsembleMesh, ensemble_mesh

__all__ = [
    "init_distributed",
    "is_distributed",
    "global_ensemble_mesh",
    "local_batch_slice",
]

#: Seconds :func:`init_distributed` waits for the other processes (and each
#: collective later), unless given ``timeout=``.
DEFAULT_TIMEOUT_S = 120.0

#: The launcher variables of ``torch.distributed``'s ``env://`` rendezvous.
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def is_distributed() -> bool:
    """True when a process group of more than one process is open."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _world():
    """``(rank, world size)``: ``(0, 1)`` outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> bool:
    """Open the process group.  Returns True if it is (or already was) open,
    False when no coordinator is given and the environment names none.

    ``coordinator_address`` is ``host:port`` (or ``tcp://host:port``) of
    rank 0's store, with ``num_processes`` and ``process_id`` this
    process's world size and rank.  With all three None the launcher's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
    is used where it is complete; otherwise this is a no-op, so library
    code can call it unconditionally.  Keywords: ``backend`` (NCCL where
    the process sees a card, else gloo), ``timeout`` in seconds
    (:data:`DEFAULT_TIMEOUT_S`): explicit arguments that cannot form the
    group raise within it.  With NCCL, set the current device
    (``torch.cuda.set_device``) before the first collective."""
    if dist.is_initialized():
        return True
    backend = kwargs.pop("backend", None) or (
        "nccl" if torch.cuda.is_available() else "gloo")
    timeout = datetime.timedelta(seconds=float(kwargs.pop("timeout", DEFAULT_TIMEOUT_S)))
    if coordinator_address is None and num_processes is None and process_id is None:
        if not all(os.environ.get(k) for k in _ENV):
            return False
        dist.init_process_group(backend, init_method="env://", timeout=timeout, **kwargs)
        return True
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed: give coordinator_address, num_processes and "
                         "process_id together")
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(backend, init_method=address, world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout, **kwargs)
    return True


def global_ensemble_mesh(*, param_axis: int = 1,
                         devices: Optional[Sequence] = None) -> EnsembleMesh:
    """The ensemble×param mesh over every process's devices, in rank order.

    Each process contributes its local devices (``devices``, every CUDA
    device it sees by default) through one ``all_gather_object``; the mesh
    records the rank that drives each, so
    :func:`~hamilton_tpu_torch.ensemble.evolve_ensemble_sharded` runs this
    process's shards and reduces its statistics across the others.  Every
    process must contribute the same number of devices."""
    local = ensemble_mesh(devices).devices.reshape(-1)
    rank, world = _world()
    names = [str(d) for d in local]
    if world > 1:
        gathered = [None] * world
        dist.all_gather_object(gathered, names)
    else:
        gathered = [names]
    if len({len(g) for g in gathered}) != 1:
        raise ValueError(f"processes hold different numbers of devices: "
                         f"{[len(g) for g in gathered]}")
    flat = [torch.device(d) for g in gathered for d in g]
    ranks = np.repeat(np.arange(world), len(names))
    n = len(flat)
    if n % param_axis != 0:
        raise ValueError(f"{n} devices not divisible by param_axis={param_axis}")
    arr = np.empty(n, dtype=object)
    arr[:] = flat
    shape = (n // param_axis, param_axis)
    return EnsembleMesh(arr.reshape(shape), ("ensemble", "param"), ranks.reshape(shape))


def local_batch_slice(global_batch: int) -> slice:
    """The half-open member range this process owns: equal contiguous
    blocks per process, in rank order.  Build this process's members with
    it and hand them to the sharded driver."""
    rank, world = _world()
    if global_batch % world != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by process count {world}"
        )
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)
