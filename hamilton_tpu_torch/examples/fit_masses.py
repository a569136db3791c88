#!/usr/bin/env python
"""Differentiable simulation: recover chain masses from an observed trajectory.

The port of ``examples/fit_masses.py``.  The true per-link masses of a
4-link pendulum chain are hidden, a short trajectory is observed, and the
masses are recovered by gradient descent (Adam) on the trajectory misfit:

    m* = argmin_m  mean ||q_sim(m; t_k) - q_obs(t_k)||²

Gradients flow through the symplectic steps, the implicit fixed-point
iterations and the SPD solves back to ``System.params``.  A chain released
from rest has q-trajectories invariant under uniform mass scaling, so the
demo starts with a nonzero momentum, which pins the scale.

Usage:
    python -m hamilton_tpu_torch.examples.fit_masses             # library leapfrog, float64
    python -m hamilton_tpu_torch.examples.fit_masses --iters 400 # longer optimization
    python -m hamilton_tpu_torch.examples.fit_masses --fused     # through the fused kernel:
                                                                 # 1024 members, shared masses,
                                                                 # fit on one member's final q, p
    ... --device cpu   (or --cpu)                                # on the CPU (the default is
                                                                 # the card)

Exits 0 when every recovered mass is within 0.05 of the true one.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200, help="Adam iterations")
    ap.add_argument("--steps", type=int, default=240, help="trajectory steps")
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument(
        "--fused", action="store_true",
        help="differentiate through the fused kernel (a 1024-member batch with "
        "shared masses, float32, one launch of up to 24 steps)",
    )
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (--device cpu)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from hamilton_tpu_torch.integrators.evolve import evolve_ham_fixed
    from hamilton_tpu_torch.integrators.fixed import make_stepper
    from hamilton_tpu_torch.models import chain
    from hamilton_tpu_torch.state import Phase

    device = torch.device("cpu" if args.cpu else (args.device or "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("fit_masses: no CUDA device; pass --device cpu to run on the CPU")
    dtype = torch.float32 if args.fused else torch.float64
    ex = chain(n_links=4, device=device, dtype=dtype)
    system = ex.system
    true_masses = torch.tensor([1.0, 0.7, 1.3, 0.9], device=device, dtype=dtype)

    # nonzero p0 breaks the uniform-mass-scaling gauge (see the docstring)
    ph0 = Phase(ex.init_phase.q, torch.tensor([0.8, -0.3, 0.5, -0.2], device=device,
                                              dtype=dtype))
    emit = max(args.steps // 12, 1)
    n_steps = (args.steps // emit) * emit

    def with_masses(m):
        return system.replace_params(dict(system.params, masses=m))

    if args.fused:
        # one fused launch on a batch of identical members; the masses are a
        # shared run-time table, so the kernel runs in its shared mode and the
        # backward replays the launch; the loss reads one member's final
        # (q, p): 2n constraints for n masses
        b = 1024
        fused_steps = min(n_steps, 24)
        phb = Phase(ph0.q.expand(b, 4).contiguous(), ph0.p.expand(b, 4).contiguous())

        def simulate(m):
            st = make_stepper(with_masses(m), "leapfrog_fused", iters=(3, 1),
                              steps_per_call=fused_steps)
            out = st.extract(st.step(st.init(phb), args.dt))
            return torch.cat([out.q[0], out.p[0]])
    else:

        def simulate(m):
            out = evolve_ham_fixed(with_masses(m), ph0, args.dt, n_steps,
                                   method="leapfrog", iters=(3, 1), emit_every=emit)
            return out.q[1:]

    with torch.no_grad():
        q_obs = simulate(true_masses)

    m = torch.ones(4, device=device, dtype=dtype, requires_grad=True)  # uninformed guess
    opt = torch.optim.Adam([m], lr=args.lr)
    t0 = time.perf_counter()
    losses = []
    for i in range(args.iters):
        opt.zero_grad()
        loss = torch.mean((simulate(m) - q_obs) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if i % max(args.iters // 10, 1) == 0:
            print(f"iter {i:4d}  loss {losses[-1]:.3e}  "
                  f"masses {[round(float(x), 4) for x in m.detach()]}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    el = time.perf_counter() - t0

    err = float((m.detach() - true_masses).abs().max())
    if losses:
        print(f"\nloss {losses[0]:.6e} -> {losses[-1]:.6e}")
    print(f"\ntrue masses      {[float(x) for x in true_masses]}")
    print(f"recovered masses {[round(float(x), 4) for x in m.detach()]}")
    print(f"max |error| = {err:.2e}   ({args.iters} iters, {el:.1f}s)")
    return 0 if err < 0.05 else 1


if __name__ == "__main__":
    raise SystemExit(main())
