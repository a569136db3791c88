#!/usr/bin/env python
"""Ensemble sweep: Lyapunov/chaos statistics for the double pendulum.

The port of ``examples/ensemble_sweep.py`` (BASELINE configs[4]): a large
ensemble sweeping initial conditions (and optionally the second mass),
evolved with a symplectic integrator, producing chaos statistics — the
largest-Lyapunov-exponent estimate per member from twin-trajectory
separation, plus energy-drift bounds as the correctness check.  It runs in
float32, as the reference does (which never enables x64).  As the
reference shards over every visible device, the sweep splits its members
over a mesh of every card the process sees when there is more than one
and they divide the batch (``evolve_ensemble_sharded``); ``--shards K``
asks for K shards of ``--device`` instead (``--device cpu --shards 4``:
four shards on the CPU).  ``"devices"`` reports the mesh's size.

Usage:
    python -m hamilton_tpu_torch.examples.ensemble_sweep --batch 16384 --steps 20000
    python -m hamilton_tpu_torch.examples.ensemble_sweep --batch 64 --steps 500 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from hamilton_tpu_torch import Phase, evolve_ensemble, evolve_ensemble_sharded
from hamilton_tpu_torch.models import double_pendulum
from hamilton_tpu_torch.parallel import ensemble_mesh
from hamilton_tpu_torch.utils import energy_drift, lyapunov_estimate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=10_000)
    ap.add_argument("--dt", type=float, default=1e-3)
    ap.add_argument("--emit-every", type=int, default=None)
    ap.add_argument("--method", default="gauss4")
    ap.add_argument("--spread", type=float, default=0.2,
                    help="half-width of the θ₁ initial-condition sweep")
    ap.add_argument("--twin-eps", type=float, default=1e-4,
                    help="twin displacement (must be representable at the "
                    "working precision; 1e-4 suits f32)")
    ap.add_argument("--mass-grid", type=int, default=0,
                    help="also sweep the second bob mass m₂ over this many "
                    "values (crossed with the θ₁ sweep) via System.params — "
                    "an (IC × parameter) grid with per-member physics")
    ap.add_argument("--mass-range", type=float, nargs=2, default=(0.5, 2.0))
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--shards", type=int, default=None,
                    help="split the members into this many shards on --device "
                    "(default: one a card when the process sees several)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("ensemble_sweep: no CUDA device; pass --device cpu to run on the CPU")
    dtype = torch.float32

    emit = args.emit_every or max(args.steps // 50, 1)
    if args.steps % emit:
        args.steps = (args.steps // emit) * emit

    ex = double_pendulum(device=device, dtype=dtype)
    b = args.batch
    system = ex.system
    m2_grid = None
    if args.mass_grid > 0:
        if b % args.mass_grid:
            raise SystemExit(
                f"--batch {b} must be divisible by --mass-grid {args.mass_grid}"
            )
        # (IC × mass) grid: member i gets mass m2_grid[i % G]; the params
        # carry the member batch axis, and every path — library, the solves,
        # the fused kernel's per-member table — evaluates per-member physics
        m2_grid = torch.linspace(args.mass_range[0], args.mass_range[1], args.mass_grid,
                                 dtype=dtype, device=device)
        m2 = m2_grid.repeat(b // args.mass_grid)
        system = ex.system.replace_params({"m1": torch.ones(b, dtype=dtype, device=device),
                                           "m2": m2})
    theta1 = torch.linspace(-args.spread, args.spread, b, dtype=dtype,
                            device=device) + ex.init_config.q[0]
    q0 = torch.stack([theta1, torch.zeros_like(theta1)], dim=-1)
    ph = Phase(q0, torch.zeros_like(q0))
    # twin members displaced by eps in θ₁ for the separation-growth estimate
    q_twin = q0.clone()
    q_twin[:, 0] += args.twin_eps
    ph_twin = Phase(q_twin, torch.zeros_like(q0))

    # the mesh over every card (the reference's, over every device it sees)
    if args.shards is not None:
        devices = [device] * args.shards
    elif device.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [device]
    mesh = None
    if len(devices) > 1:
        if b % len(devices) == 0:
            mesh = ensemble_mesh(devices)
        elif args.shards is not None:
            raise SystemExit(f"--batch {b} must be divisible by --shards {args.shards}")
        else:
            devices = [device]

    def run(p):
        if mesh is not None:
            return evolve_ensemble_sharded(system, p, args.dt, args.steps, mesh=mesh,
                                           method=args.method, emit_every=emit)
        return evolve_ensemble(system, p, args.dt, args.steps, method=args.method,
                               emit_every=emit)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    traj = run(ph)
    sync()
    elapsed = time.perf_counter() - t0
    traj_twin = run(ph_twin)

    lam = lyapunov_estimate(system, traj, traj_twin, args.dt * emit).cpu().numpy()
    drift = energy_drift(system, traj).cpu().numpy()

    out = {
        "batch": b,
        "steps": args.steps,
        "dt": args.dt,
        "method": args.method,
        "member_steps_per_sec": b * args.steps / elapsed,
        "lyapunov_mean": float(lam.mean()),
        "lyapunov_max": float(lam.max()),
        "chaotic_fraction": float((lam > 0.05).mean()),
        "max_energy_drift": float(drift.max()),
        "devices": len(devices),
    }
    if m2_grid is not None:
        # member i carries mass m2_grid[i % G] → (IC, mass) reshape
        lam_by_mass = lam.reshape(-1, args.mass_grid)
        out["mass_grid_m2"] = [float(m) for m in m2_grid.cpu().numpy()]
        out["chaotic_fraction_by_mass"] = [
            float(f) for f in (lam_by_mass > 0.05).mean(axis=0)
        ]
    if args.json:
        print(json.dumps(out))
        return 0
    print(f"double-pendulum ensemble sweep: {b} members × {args.steps} steps "
          f"({args.method}, dt={args.dt})")
    print(f"  throughput           {out['member_steps_per_sec']:.3e} member-steps/s "
          f"on {len(devices)} device(s)")
    print(f"  max |ΔH/H₀|          {out['max_energy_drift']:.3e}")
    print(f"  λ̂ (largest Lyapunov) mean {out['lyapunov_mean']:.3f}, "
          f"max {out['lyapunov_max']:.3f}")
    print(f"  chaotic fraction     {out['chaotic_fraction']:.1%}  (λ̂ > 0.05)")
    if m2_grid is not None:
        print("  chaotic fraction by m₂ (params sweep):")
        for m, f in zip(out["mass_grid_m2"], out["chaotic_fraction_by_mass"]):
            print(f"    m₂ = {m:5.2f}: {f:6.1%} " + "#" * int(30 * f))
    # coarse histogram of λ̂ across the IC sweep
    lo, hi = lam.min(), lam.max()
    if hi > lo:
        hist, edges = np.histogram(lam, bins=12)
        peak = hist.max()
        print("  λ̂ distribution over the θ₁ sweep:")
        for h, e0, e1 in zip(hist, edges[:-1], edges[1:]):
            bar = "#" * int(40 * h / peak)
            print(f"    [{e0:6.3f},{e1:6.3f}) {bar}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
