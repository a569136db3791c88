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
leaves have no ``.npz`` form and are refused.  The reference's orbax backend
goes with the sharded path (ROADMAP M13).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from hamilton_tpu_torch.state import Phase

__all__ = ["save_checkpoint", "load_checkpoint"]

_META_KEY = "__hamilton_meta__"


def _children(node) -> Optional[list]:
    """A container's children in flattening order, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, torch.Tensor):
        return None
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
        return torch.from_numpy(next(leaves)).to(at)
    built = [_rebuild(kid, leaves, device) for kid in kids]
    if like is None:
        return None
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
