"""The one generator of the benchmark's traffic: each job's initial
conditions, made on the device from ``--seed`` and the job's index.

A traffic file (``traffic/<name>.json``) gives ``members`` and one of two
kinds of initial state, both at rest:

- ``"jitter"``: the configuration's ``initial_q`` plus ``jitter`` times a
  standard normal draw on every angle (the bench's ensembles);
- ``"grid"``: ``grid = [rows, cols]`` cells over ``span = [lo, hi]`` in
  both angles of a two-angle system, one member a cell at a uniform point
  inside it (a chaos map).

Every seed gets the same sizes; the seed moves only the draws.
"""

from __future__ import annotations

import hashlib
from typing import Tuple

import torch

__all__ = ["job_seed", "initial_state"]


def job_seed(seed: int, job: int) -> int:
    """A 60-bit generator seed for one job of one run."""
    return int(hashlib.sha256(f"{seed}:{job}".encode()).hexdigest()[:15], 16)


def initial_state(config: dict, traffic: dict, seed: int, job: int, device,
                  dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, p)``, each ``(members, n)`` in ``dtype`` on ``device``."""
    members = int(traffic["members"])
    base = torch.tensor(config["initial_q"], dtype=dtype, device=device)
    n = base.numel()
    gen = torch.Generator(device=device)
    gen.manual_seed(job_seed(seed, job))
    kind = traffic["initial"]
    if kind == "jitter":
        z = torch.randn(members, n, generator=gen, device=device, dtype=dtype)
        q = base + traffic["jitter"] * z
    elif kind == "grid":
        rows, cols = traffic["grid"]
        lo, hi = traffic["span"]
        if n != 2 or rows * cols != members:
            raise ValueError(f"a grid of {rows} x {cols} cells needs two angles and "
                             f"{rows * cols} members, got {n} and {members}")
        u = torch.rand(members, 2, generator=gen, device=device, dtype=dtype)
        cell = torch.arange(members, device=device)
        index = torch.stack([cell // cols, cell % cols], dim=1).to(dtype)
        width = torch.tensor([(hi - lo) / rows, (hi - lo) / cols], dtype=dtype, device=device)
        q = lo + (index + u) * width
    else:
        raise ValueError(f"unknown initial state {kind!r}: 'jitter' or 'grid'")
    return q.contiguous(), torch.zeros_like(q)
