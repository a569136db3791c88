"""Device meshes and ensemble shards.

PyTorch counterpart of :mod:`hamilton_tpu.parallel.mesh`.  The layout is
the reference's: a mesh whose first axis is the **ensemble** (members split
over devices, the physics analog of data parallelism), optionally refined
by a **param** axis for parameter-sweep grids.  A member's state is 2n
numbers, so nothing else is worth splitting.

Where the reference hands a ``jax.sharding.Mesh`` to GSPMD, the port keeps
the mesh as what it is to one process: an array of ``torch.device`` s (a
device may repeat, so several shards can share one card or the CPU), each
with the rank of the process that drives it.  A shard is an ordinary
tensor on its device; :func:`shard_phase` makes them and
:meth:`ShardedPhase.gather` puts them back together.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from hamilton_tpu_torch.state import Phase

__all__ = ["ensemble_mesh", "ensemble_sharding", "replicated_sharding", "shard_phase"]


class EnsembleMesh:
    """A ``(n // param_axis, param_axis)`` array of devices with axis names.

    ``devices`` holds the ``torch.device`` s and ``ranks`` the process rank
    that drives each (all this process's for a local mesh; a global mesh,
    :func:`~hamilton_tpu_torch.parallel.global_ensemble_mesh`, lists every
    process's devices in rank order).  ``shape`` maps each axis name to its
    size, as the reference's ``Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, str],
                 ranks: Optional[np.ndarray] = None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device array needs as many axis names, "
                             f"got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.ranks = np.zeros(devices.shape, dtype=int) if ranks is None else ranks
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def axis_devices(self, axis: str):
        """``[(device, rank)]`` along ``axis``, the other axes at index 0:
        where each of the axis's shards runs."""
        index = self.axis_names.index(axis)
        take = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[index]):
            take[index] = i
            out.append((self.devices[tuple(take)], int(self.ranks[tuple(take)])))
        return out

    def __repr__(self) -> str:
        shape = ", ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"EnsembleMesh({shape}, devices={[str(d) for d in self.devices.flat]})"


def _local_devices():
    """Every CUDA device this process sees; raises without one."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "ensemble_mesh: no CUDA device, and no devices were given; pass "
            "devices=['cpu'] * k for k shards on the CPU"
        )
    return [torch.device("cuda", i) for i in range(count)]


def ensemble_mesh(devices: Optional[Sequence] = None, *, param_axis: int = 1,
                  axis_names=("ensemble", "param")) -> EnsembleMesh:
    """A mesh over ``devices`` (``torch.device`` s or their names, repeats
    allowed) with an ensemble axis and a param-sweep axis of size
    ``param_axis``; with ``param_axis == 1`` the 1-D ensemble mesh of an IC
    sweep.  ``devices=None`` takes every CUDA device this process sees (in
    a process group, its local ones), and raises where there is none: the
    mesh never falls back to the CPU unasked."""
    devices = _local_devices() if devices is None else [torch.device(d) for d in devices]
    n = len(devices)
    if n == 0 or n % param_axis != 0:
        raise ValueError(f"{n} devices not divisible by param_axis={param_axis}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return EnsembleMesh(arr.reshape(n // param_axis, param_axis), axis_names)


@dataclass(frozen=True)
class Sharding:
    """Which mesh axes split which batch axis: ``spec[k]`` names the mesh
    axes (a tuple, folded in order) that batch axis ``k`` splits over; an
    empty ``spec`` replicates."""

    mesh: EnsembleMesh
    spec: Tuple[Tuple[str, ...], ...]

    def grid(self) -> Tuple[int, ...]:
        """The number of shards along each split batch axis."""
        return tuple(int(np.prod([self.mesh.shape[a] for a in axes])) for axes in self.spec)


def ensemble_sharding(mesh: EnsembleMesh, *, batch_ndim: int = 1) -> Sharding:
    """The leading batch axis split over the ensemble axis and, with
    ``batch_ndim=1``, the param axis folded in (where it is larger than 1);
    with ``batch_ndim=2`` the second batch axis split over the param axis."""
    names = list(mesh.axis_names)
    if batch_ndim == 1:
        spec = (tuple(a for a in names if mesh.shape[a] > 1) or (names[0],),)
    elif batch_ndim == 2:
        spec = ((names[0],), (names[1],))
    else:
        raise ValueError(f"batch_ndim must be 1 or 2, got {batch_ndim}")
    return Sharding(mesh, spec)


def replicated_sharding(mesh: EnsembleMesh) -> Sharding:
    """Every device holds the whole value."""
    return Sharding(mesh, ())


@dataclass(frozen=True)
class ShardedPhase:
    """A batch of members as shards on their devices: ``shards`` in mesh
    order (row-major over ``grid``, one shard a device of this process),
    each a :class:`Phase` block of equal size along each split batch axis."""

    shards: Tuple[Phase, ...]
    grid: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def gather(self, device=None) -> Phase:
        """The members back together, on ``device`` (the first shard's by
        default)."""
        device = self.shards[0].q.device if device is None else torch.device(device)

        def join(get):
            parts = [get(s).to(device) for s in self.shards]
            if len(self.grid) == 1:
                return torch.cat(parts, dim=0)
            cols = self.grid[1]
            rows = [torch.cat(parts[r * cols:(r + 1) * cols], dim=1)
                    for r in range(self.grid[0])]
            return torch.cat(rows, dim=0)

        return Phase(join(lambda s: s.q), join(lambda s: s.p))


def _split(x: torch.Tensor, grid, devices):
    """``x``'s equal contiguous blocks over ``grid`` (its leading axes), in
    row-major order, each onto its device."""
    if len(grid) == 1:
        blocks = list(torch.tensor_split(x, grid[0], dim=0))
    else:
        blocks = [b for row in torch.tensor_split(x, grid[0], dim=0)
                  for b in torch.tensor_split(row, grid[1], dim=1)]
    return [b.to(d).contiguous() for b, d in zip(blocks, devices)]


def shard_phase(phase: Phase, mesh: EnsembleMesh, *, batch_ndim: int = 1) -> ShardedPhase:
    """Split a batched :class:`Phase` over the mesh
    (:func:`ensemble_sharding`): equal contiguous blocks of members in mesh
    order, each copied onto its device.  ``phase`` holds this process's
    members; in a process group with a global mesh they split over this
    process's devices.  Raises when a batch axis does not divide."""
    grid = ensemble_sharding(mesh, batch_ndim=batch_ndim).grid()
    dist = torch.distributed
    mine = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    devices = [d for d, r in zip(mesh.devices.flat, mesh.ranks.flat) if r == mine]
    if len(grid) == 1:
        grid = (len(devices),)
    elif len(devices) != mesh.size:
        raise ValueError("a 2-D batch grid splits over a mesh of this process's devices only")
    for k, g in enumerate(grid):
        if phase.q.shape[k] % g != 0:
            raise ValueError(f"batch axis {k} of size {phase.q.shape[k]} not divisible into "
                             f"{g} shards")
    qs, ps = _split(phase.q, grid, devices), _split(phase.p, grid, devices)
    return ShardedPhase(tuple(Phase(q, p) for q, p in zip(qs, ps)), tuple(grid), tuple(devices))
