"""Checkpoint / resume for long-horizon ensemble runs.

PyTorch counterpart of :mod:`hamilton_tpu.utils.checkpoint`, in its file
layout: an ``.npz`` of the state's leaves (``leaf_0``, ``leaf_1``, ...) and
the JSON bytes of ``__hamilton_meta__`` (step, leaf count, whether the state
was a :class:`Phase`, the caller's extras), published atomically through a
``.tmp`` file and ``os.replace``.  So a checkpoint written by either package
loads in the other, bit for bit.  The resume from a checkpoint is the
straight run's, bit for bit.

A state is a tree of tensors: a :class:`Phase` or :class:`Config`, tuples,
lists, dicts (by sorted key), ``NamedTuple`` s such as a stepper's carry,
dataclasses (by field); ``None`` holds no leaf.  Its leaves are flattened in
that fixed order (the reference's for the same containers), saved from any
device, and loaded with their dtypes and bits onto ``like``'s devices, or
onto ``device`` (the card unless the caller asks for the CPU).  bfloat16
leaves have no ``.npz`` form and are refused.

:func:`save_orbax` and :func:`load_orbax` keep the reference's names for
its sharding-aware backend, but write ``torch.distributed.checkpoint``
(DCP) directories, not orbax files: orbax is a JAX library.  The ``.npz``
of :func:`save_checkpoint` stays the format that crosses between the
packages.  The shards of :func:`~hamilton_tpu_torch.parallel.shard_phase`
save and restore onto their devices.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from hamilton_tpu_torch.parallel.mesh import ShardedPhase
from hamilton_tpu_torch.state import Phase

__all__ = ["save_checkpoint", "load_checkpoint", "save_orbax", "load_orbax"]

_META_KEY = "__hamilton_meta__"


def _children(node) -> Optional[list]:
    """A container's children in flattening order, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, torch.Tensor):
        return None
    if isinstance(node, ShardedPhase):
        return list(node.shards)
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(node)
    if isinstance(node, (tuple, list)):
        return list(node)
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [getattr(node, f.name) for f in dataclasses.fields(node)]
    return None


def _flatten(node, out: List) -> None:
    kids = _children(node)
    if kids is None:
        out.append(node)
    else:
        for kid in kids:
            _flatten(kid, out)


def _rebuild(like, leaves, device):
    """``like``'s structure with the next leaves of the iterator ``leaves``:
    a tensor leaf onto the device ``like``'s leaf lies on, any other onto
    ``device``."""
    kids = _children(like)
    if kids is None:
        at = like.device if isinstance(like, torch.Tensor) else device
        return torch.as_tensor(next(leaves)).to(at)
    built = [_rebuild(kid, leaves, device) for kid in kids]
    if like is None:
        return None
    if isinstance(like, ShardedPhase):
        return ShardedPhase(tuple(built), like.grid, like.devices)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*built)
    if isinstance(like, (tuple, list)):
        return type(like)(built)
    if isinstance(like, dict):
        return {k: v for k, v in zip(sorted(like), built)}
    return type(like)(**{f.name: v for f, v in zip(dataclasses.fields(like), built)})


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("save_checkpoint: a bfloat16 leaf has no .npz form")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, state, *, step: int = 0,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Save a state ``state`` (a :class:`Phase`, a stepper carry, or any
    nested container of tensors) to ``path`` (.npz): its flattened leaves,
    and a step counter and ``extra`` for resume bookkeeping."""
    leaves: List = []
    _flatten(state, leaves)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    meta = {
        "step": step,
        "n_leaves": len(leaves),
        "is_phase": isinstance(state, Phase),
        "extra": extra or {},
    }
    arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic publish: no torn checkpoints on a crash


def load_checkpoint(path: str, like=None, *,
                    device="cuda") -> Tuple[Any, int, Dict[str, Any]]:
    """Load a checkpoint.  Returns ``(state, step, extra)``.

    With ``like`` given (a state of the same structure), the leaves are
    rebuilt into that structure on its leaves' devices; otherwise a bare
    :class:`Phase` (if saved from one) or a list of tensors on ``device``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY].tobytes()).decode("utf-8"))
        leaves = [z[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    device = torch.device(device)
    if like is not None:
        want: List = []
        _flatten(like, want)
        if len(want) != len(leaves):
            raise ValueError(f"load_checkpoint: {path} holds {len(leaves)} leaves, like= "
                             f"has {len(want)}")
        state = _rebuild(like, iter(leaves), device)
    else:
        tensors = [torch.from_numpy(leaf).to(device) for leaf in leaves]
        state = Phase(*tensors) if meta["is_phase"] and len(tensors) == 2 else tensors
    return state, meta["step"], meta["extra"]


def _dcp_prefix() -> str:
    """This process's keys in a DCP checkpoint: each rank's own."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return f"rank{rank}/"


def _dcp_quietly(fn, *args, **kwargs):
    """A DCP call without its warning that one process saves or loads
    alone (which it says again on every call outside a process group)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=r".*single process", category=UserWarning)
        return fn(*args, **kwargs)


def save_orbax(path: str, state) -> None:
    """Save a state (as :func:`save_checkpoint` takes it, or the shards of
    :func:`~hamilton_tpu_torch.parallel.shard_phase`) into the directory
    ``path`` with ``torch.distributed.checkpoint``: DCP files, not orbax's
    (the reference's format is a JAX library's).  In a process group every
    rank calls it with its own state, collectively: each rank writes its
    own leaves under its rank's keys, from the devices they lie on.  bfloat16
    leaves are kept."""
    import torch.distributed.checkpoint as dcp

    leaves: List = []
    _flatten(state, leaves)
    prefix = _dcp_prefix()
    sd: Dict[str, Any] = {f"{prefix}leaf_{i}": torch.as_tensor(leaf)
                          for i, leaf in enumerate(leaves)}
    sd[f"{prefix}meta"] = json.dumps({"n_leaves": len(leaves),
                                      "is_phase": isinstance(state, Phase)})
    _dcp_quietly(dcp.save, sd, checkpoint_id=os.path.abspath(path))


def load_orbax(path: str, like=None, *, device="cuda"):
    """Restore this process's state saved with :func:`save_orbax` (in a
    process group, collectively, by the same ranks).  With ``like`` (a
    state of the same structure, :class:`Phase` and shards included) each
    leaf is read onto the device of ``like``'s; otherwise a bare
    :class:`Phase` (if saved from one) or a list of tensors on ``device``
    (the card unless the caller asks for the CPU)."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    prefix = _dcp_prefix()
    stored = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    n = sum(1 for key in stored if key.startswith(f"{prefix}leaf_"))
    if like is not None:
        want: List = []
        _flatten(like, want)
        if len(want) != n:
            raise ValueError(f"load_orbax: {path} holds {n} leaves for this rank, like= has "
                             f"{len(want)}")
        sd: Dict[str, Any] = {f"{prefix}leaf_{i}": torch.empty_like(torch.as_tensor(x))
                              for i, x in enumerate(want)}
    else:
        device = torch.device(device)
        sd = {}
        for i in range(n):
            md = stored[f"{prefix}leaf_{i}"]
            sd[f"{prefix}leaf_{i}"] = torch.empty(tuple(md.size), dtype=md.properties.dtype,
                                                  device=device)
    sd[f"{prefix}meta"] = ""
    _dcp_quietly(dcp.load, sd, checkpoint_id=path)
    leaves = [sd[f"{prefix}leaf_{i}"] for i in range(n)]
    meta = json.loads(sd[f"{prefix}meta"])
    if like is not None:
        return _rebuild(like, iter(leaves), torch.device(device))
    if meta["is_phase"] and n == 2:
        return Phase(*leaves)
    return leaves
