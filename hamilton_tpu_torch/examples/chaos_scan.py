#!/usr/bin/env python
"""Chaos map of the double pendulum over an (angle × mass) parameter grid.

The port of ``examples/chaos_scan.py``.  Every grid cell is a double
pendulum with its own initial angle θ₀ and its own second-bob mass m₂ (a
batched ``System.params`` sweep), evolved as one ensemble, with the largest
Lyapunov exponent measured by streaming Benettin pairs
(``utils.LyapunovPairs``): the renormalized log-growth accumulates inside
the evolution loop, so no trajectory is emitted.

Output: an ASCII heat map (rows = m₂, cols = θ₀) of λ_max.  The lower rows
(light m₂) stay regular at small angles while the high-energy right side
goes chaotic.

``--fused`` runs the fused kernel (K1's dense n = 2 chain with per-member
tables, (3, 1), float32, ``--emit-every`` steps a launch, the pairs
renormalized between launches); without it the library leapfrog runs in
float64.  The ensemble is the grid's 2·rows·cols pair members, unpadded.

Usage:
    python -m hamilton_tpu_torch.examples.chaos_scan           # on the card, 48×16 grid
    python -m hamilton_tpu_torch.examples.chaos_scan --cols 64 --rows 24
    python -m hamilton_tpu_torch.examples.chaos_scan --fused   # the fused kernel
    ... --device cpu                                           # on the CPU
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from hamilton_tpu_torch.ensemble import evolve_ensemble_final
from hamilton_tpu_torch.models import chain
from hamilton_tpu_torch.state import Phase
from hamilton_tpu_torch.utils.observables import LyapunovPairs

RAMP = " .:-=+*#%@"


def grid(rows: int, cols: int, dtype, device):
    """The scan's axes: θ₀ over ``cols`` points, m₂ over ``rows``."""
    theta = torch.linspace(0.15, math.pi - 0.15, cols, dtype=dtype, device=device)
    m2 = torch.linspace(0.2, 3.0, rows, dtype=dtype, device=device)
    return theta, m2


def chaos_setup(rows: int, cols: int, *, eps: float, device, dtype):
    """The scan's ensemble: ``(system, pairs, theta, m2)``: the n = 2
    serial chain (unit first arm, half-length second arm, gravity 5) with
    each grid cell's masses ``(1, m₂)`` for both members of its Benettin
    pair, and the pairs' initial phase ``(2·rows·cols, 2)`` (θ₀, 0 at rest,
    the partner displaced by ``eps``)."""
    b = rows * cols
    ex = chain(n_links=2, gravity=5.0, device=device, dtype=dtype)
    theta, m2 = grid(rows, cols, dtype, device)
    mg, tg = torch.meshgrid(m2, theta, indexing="ij")  # (rows, cols)
    tg, mg = tg.reshape(-1), mg.reshape(-1)  # (b,)

    def per_pair(x):
        """Each grid cell's params for both members of its pair."""
        return torch.repeat_interleave(x, 2, dim=0)

    q0 = torch.stack([tg, torch.zeros_like(tg)], dim=-1)  # (b, 2)
    pairs = LyapunovPairs.pair_ensemble(Phase(q0, torch.zeros_like(q0)), eps)
    arms = torch.tensor([1.0, 0.5], dtype=dtype, device=device)
    system = ex.system.replace_params({
        "masses": per_pair(torch.stack([torch.ones_like(mg), mg], dim=-1)),
        "lengths": per_pair(arms.expand(b, 2)),
        "gravity": per_pair(torch.full((b,), 5.0, dtype=dtype, device=device)),
    })
    return system, pairs, theta, m2


def chaos_map(rows: int = 16, cols: int = 48, *, steps: int = 4000, dt: float = 5e-3,
              emit_every: int = 40, eps=None, fused: bool = False, device="cuda",
              dtype=None):
    """λ_max on the (rows = m₂, cols = θ₀) grid, a ``(rows, cols)`` tensor:
    the ensemble of :func:`chaos_setup` evolved ``steps`` steps of ``dt``
    with the Benettin pairs renormalized every ``emit_every`` steps; in
    float32 when ``fused``, else float64, unless ``dtype`` says."""
    if dtype is None:
        dtype = torch.float32 if fused else torch.float64
    if eps is None:
        eps = 1e-4 if dtype == torch.float32 else 1e-7
    system, pairs, _, _ = chaos_setup(rows, cols, eps=eps, device=device, dtype=dtype)
    lp = LyapunovPairs(d0=eps)
    _, _, obs = evolve_ensemble_final(
        system, pairs, dt, steps,
        method="leapfrog_fused" if fused else "leapfrog", iters=(3, 1),
        track_drift=False, drift_every=steps, observable=lp, obs_every=emit_every,
        # fused: the whole span between renormalizations in one launch
        steps_per_call=emit_every if fused else 1,
    )
    return lp.lyapunov(obs, dt * steps).reshape(rows, cols)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cols", type=int, default=48,
                    help="θ₀ grid points (default 48)")
    ap.add_argument("--rows", type=int, default=16,
                    help="m₂ grid points (default 16)")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--dt", type=float, default=5e-3)
    ap.add_argument("--emit-every", type=int, default=40)
    ap.add_argument("--eps", type=float, default=None,
                    help="initial separation of the trajectory pairs "
                    "(default 1e-7, or 1e-4 in the f32 --fused mode where "
                    "1e-7 sits at the round-off floor)")
    ap.add_argument("--fused", action="store_true",
                    help="run the fused kernel (float32, --emit-every steps a launch)")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("chaos_scan: no CUDA device; pass --device cpu to run on the CPU")
    if args.eps is None:
        args.eps = 1e-4 if args.fused else 1e-7
    rows, cols = args.rows, args.cols
    method = "leapfrog_fused" if args.fused else "leapfrog"
    theta, m2 = grid(rows, cols, torch.float32 if args.fused else torch.float64, "cpu")

    t0 = time.perf_counter()
    lam = chaos_map(rows, cols, steps=args.steps, dt=args.dt, emit_every=args.emit_every,
                    eps=args.eps, fused=args.fused, device=device)
    lam = torch.nan_to_num(lam, nan=0.0).cpu()
    el = time.perf_counter() - t0

    lo, hi = float(lam.min()), float(lam.max())
    # λ ≤ 0 means regular — blank it so one deeply-negative cell can't
    # compress the chaotic range's contrast
    span = max(hi, 1e-12)
    idx = torch.clamp((torch.clamp(lam, min=0.0) / span * (len(RAMP) - 1)).to(torch.int32),
                      0, len(RAMP) - 1)

    print(f"λ_max over θ₀ ∈ [{float(theta[0]):.2f}, {float(theta[-1]):.2f}] "
          f"(→) × m₂ ∈ [{float(m2[0]):.2f}, {float(m2[-1]):.2f}] (↓)")
    print(f"{rows}×{cols} grid, {2 * rows * cols}-member ensemble ({method}), "
          f"{args.steps} steps: {el:.1f}s")
    print(f"λ range [{lo:.3f}, {hi:.3f}]   ramp '{RAMP}'")
    for r in range(rows):
        row = "".join(RAMP[int(idx[r, c])] for c in range(cols))
        print(f"m₂={float(m2[r]):4.2f} |{row}|")

    # sanity: the high-angle side must be more chaotic than the small-angle
    # side
    w = max(cols // 4, 1)
    left = float(lam[:, :w].mean())
    right = float(lam[:, -w:].mean())
    print(f"mean λ: small angles {left:.3f}, large angles {right:.3f}")
    return 0 if right > left and hi > 0.0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
