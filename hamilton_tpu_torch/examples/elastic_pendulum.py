#!/usr/bin/env python
"""Elastic pendulum — a user-defined system on the fused kernel.

The port of ``examples/elastic_pendulum.py``.  A point mass on a massless
spring, free to swing, is not among the bundled models: everything below
goes through the port's public API.

1.  The library definition is a coordinate map and a Cartesian potential
    handed to :func:`hamilton_tpu_torch.mk_system_cart` (the AD-powered
    correctness reference, on every integrator).
2.  The fused definition is one :class:`~hamilton_tpu_torch.ops.fused_step.
    FusedForms` factory declaring the closed forms against ``FM_TORCH``:
    the aux tuple, the mass-matrix entries, ∂H/∂q and the potential.
    Attached with ``mk_system_cart(..., fused_forms=...)``, it makes
    ``method="leapfrog_fused"`` (and the Suzuki/Yoshida compositions) run
    on every ensemble driver — on the card through a Hopper kernel built
    from these forms at first use (``ops.fused_codegen``), with parameter
    sweeps as per-member coefficient tables.

Closed forms, for q = (θ, r) with θ from the downward vertical and r the
spring length (pivot at the origin, z up):

    x = (r sinθ, −r cosθ)            K(q) = J^T M J = m · diag(r², 1)
    U  = −m·g·r·cosθ + ½k(r − l₀)²
    ∂H/∂θ = m·g·r·sinθ
    ∂H/∂r = k(r − l₀) − m·g·cosθ − m·r·w_θ²

The demo physics is the elastic pendulum's autoparametric 2:1 resonance:
radial oscillation pumps the swing when ω_spring = 2·ω_pendulum, i.e.
k/m = 4g/l_eq with l_eq = l₀ + mg/k, which solves to k_res = 3·m·g/l₀.  The
script sweeps k across the ensemble (per-member spring constants), starts
each member in a pure radial oscillation with a small swing seed, streams
the running max |θ| through the evolution loop (``RunningExtrema``; no
trajectory is emitted), and checks that the amplification peaks at k_res.

Usage:
    python -m hamilton_tpu_torch.examples.elastic_pendulum             # library leapfrog, f64
    python -m hamilton_tpu_torch.examples.elastic_pendulum --sweep 96  # finer k grid
    python -m hamilton_tpu_torch.examples.elastic_pendulum --fused     # the fused kernel, f32
    ... --device cpu                                                   # on the CPU (the
                                                                       # default is the card)

Exits 0 when the parity check passes and the resonance peak lies within
25 % of k_res.
"""

from __future__ import annotations

import argparse
import time

RAMP = " .:-=+*#%@"


def make_system(mass=1.0, gravity=9.8, spring_k=30.0, rest_length=1.0, *, device="cpu",
                dtype=None):
    """The elastic-pendulum :class:`~hamilton_tpu_torch.system.System`
    through the public constructor: the library path and the fused family.

    All four physical parameters live in ``System.params``, so they are
    sweepable per member and differentiable.
    """
    import torch

    from hamilton_tpu_torch import mk_system_cart

    dtype = torch.float64 if dtype is None else dtype
    params = {"mass": mass, "gravity": gravity, "spring_k": spring_k,
              "rest_length": rest_length}

    def inertia_fn(p):
        return torch.stack([p["mass"], p["mass"]])

    def coords(q, p):
        th, r = q[0], q[1]
        return torch.stack([r * torch.sin(th), -r * torch.cos(th)])

    def potential_cart(x, p):
        stretch = torch.sqrt(x[0] * x[0] + x[1] * x[1]) - p["rest_length"]
        return (
            (p["gravity"] * p["mass"]).to(x.dtype) * x[1]
            + 0.5 * p["spring_k"].to(x.dtype) * stretch * stretch
        )

    # ---- the fused-family contract: one declarative factory -----------
    # Coefficient table (one table, four entries): (m, g·m, k, l₀).
    def fused_forms(system):
        from hamilton_tpu_torch.ops.fused_step import (
            FamilyFns, FusedForms, concrete_scalar,
        )

        p = system.params
        cs = [concrete_scalar(p[k_])
              for k_ in ("mass", "gravity", "spring_k", "rest_length")]
        consts = None
        if all(c is not None for c in cs):
            m_c, g_c, k_c, l_c = cs
            consts = ((m_c, g_c * m_c, k_c, l_c),)

        def arrays_fn(dtype, device):
            m_, g_, k_, l_ = (p[k_].to(device=device, dtype=dtype)
                              for k_ in ("mass", "gravity", "spring_k", "rest_length"))
            return (torch.stack([m_, g_ * m_, k_, l_], dim=-1),)

        def make(at, fm):
            mass = lambda: at[0](0)  # noqa: E731
            gm = lambda: at[0](1)    # noqa: E731  g·m
            kspr = lambda: at[0](2)  # noqa: E731
            l0 = lambda: at[0](3)    # noqa: E731

            def aux(q):
                return (fm.sin(q[0]), fm.cos(q[0]))

            def k_at(aux_v, q):
                s, _ = aux_v
                r = q[1]

                def at_(i, j):
                    if (i, j) == (0, 0):
                        return mass() * (r * r)
                    if (i, j) == (1, 1):
                        return fm.full(mass(), s)
                    return fm.zero(s)

                return at_

            def dhdq(aux_v, q, w):
                s, c = aux_v
                r = q[1]
                return [
                    gm() * (r * s),
                    kspr() * r - kspr() * l0() - gm() * c
                    - mass() * r * (w[0] * w[0]),
                ]

            def potential(aux_v, q):
                s, c = aux_v
                r = q[1]
                d = r - l0()
                return (kspr() * d) * d * 0.5 - gm() * (r * c)

            return FamilyFns(aux, k_at, dhdq, potential)

        return FusedForms(
            n=2, n_aux=2, coef_lens=(4,), consts=consts,
            arrays_fn=arrays_fn, make=make, name="elastic_pendulum",
        )

    return mk_system_cart(
        None, coords, potential_cart, device=device, dtype=dtype, n=2,
        name="elastic_pendulum", params=params, inertia_fn=inertia_fn,
        fused_forms=fused_forms,
    )


def main(argv=None, results=None) -> int:
    """Run the parity stage and the resonance sweep; 0 when both pass.
    ``results``, when a dict, receives the run's readings."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", type=int, default=64,
                    help="spring-constant grid points (default 64)")
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--dt", type=float, default=5e-3)
    ap.add_argument("--mass", type=float, default=1.0)
    ap.add_argument("--gravity", type=float, default=9.8)
    ap.add_argument("--rest-length", type=float, default=1.0)
    ap.add_argument("--amp", type=float, default=0.15,
                    help="initial radial stretch beyond equilibrium")
    ap.add_argument("--theta0", type=float, default=0.01,
                    help="swing seed angle (rad)")
    ap.add_argument("--fused", action="store_true",
                    help="run the fused kernel (float32, (2,1) iterations)")
    ap.add_argument("--skip-parity", action="store_true",
                    help="skip the fused≡library check")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.ensemble import evolve_ensemble_final
    from hamilton_tpu_torch.integrators.fixed import make_stepper
    from hamilton_tpu_torch.mechanics import to_phase
    from hamilton_tpu_torch.state import Config, Phase
    from hamilton_tpu_torch.utils.observables import RunningExtrema

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("elastic_pendulum: no CUDA device; pass --device cpu")
    results = {} if results is None else results
    f64 = torch.float64
    dtype = torch.float32 if args.fused else f64
    m, g, l0 = args.mass, args.gravity, args.rest_length
    k_res = 3.0 * m * g / l0

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # ---- stage 1: fused ≡ library parity through the public API -------
    # The library step is AD-generic; the fused step runs the hand-declared
    # closed forms (on the card, the kernel generated from them).  Agreement
    # to ~1e-12 in float64 shows the forms are the same physics.
    if not args.skip_parity:
        sys_sh = make_system(m, g, spring_k=k_res, rest_length=l0, device=device, dtype=f64)
        rng = np.random.default_rng(0)
        q = np.stack([0.3 + 0.02 * rng.standard_normal(1024),
                      l0 + 0.1 * rng.standard_normal(1024)], axis=-1)
        p = 0.05 * rng.standard_normal((1024, 2))
        ph = Phase(torch.tensor(q, device=device, dtype=f64),
                   torch.tensor(p, device=device, dtype=f64))
        dt_par = torch.tensor(1e-3, dtype=f64)
        lib = make_stepper(sys_sh, "leapfrog", iters=(3, 2))
        fus = make_stepper(sys_sh, "leapfrog_fused", iters=(3, 2))
        t0 = time.perf_counter()
        c_lib, c_fus = lib.init(ph), fus.init(ph)
        for _ in range(2):
            c_lib = lib.step(c_lib, dt_par)
            c_fus = fus.step(c_fus, dt_par)
        a, b = lib.extract(c_lib), fus.extract(c_fus)
        err = max(float((a.q - b.q).abs().max()), float((a.p - b.p).abs().max()))
        mode = "the kernel" if device.type == "cuda" else "the plain version"
        print(f"[parity] fused ({mode}, float64) vs library, B=1024, 2 steps: "
              f"max|Δ| = {err:.3e}  ({time.perf_counter() - t0:.1f}s)")
        results["parity_err"] = err
        if not err < 1e-11:
            print(f"[parity] FAILED: {err:.3e} >= 1e-11")
            return 1

    # ---- stage 2: the resonance sweep as one batched ensemble ---------
    b = args.sweep
    k_grid = torch.linspace(0.35 * k_res, 2.0 * k_res, b, dtype=dtype, device=device)
    base = make_system(m, g, spring_k=float(k_grid[0]), rest_length=l0, device=device,
                       dtype=dtype)
    sysb = base.replace_params({
        "mass": torch.full((b,), m, dtype=dtype, device=device),
        "gravity": torch.full((b,), g, dtype=dtype, device=device),
        "spring_k": k_grid,
        "rest_length": torch.full((b,), l0, dtype=dtype, device=device),
    })

    # per-member equilibrium length l_eq = l₀ + mg/k; start stretched by
    # --amp with the swing seed
    l_eq = l0 + m * g / k_grid
    q0 = torch.stack([torch.full((b,), args.theta0, dtype=dtype, device=device),
                      l_eq + args.amp], dim=-1)
    v0 = torch.zeros((b, 2), dtype=dtype, device=device)
    ph0 = to_phase(sysb, Config(q0, v0))

    swing = RunningExtrema(lambda ph: torch.abs(ph.q[..., 0]))
    method = "leapfrog_fused" if args.fused else "leapfrog"
    launches0 = kernels.launch_counts()
    sync()
    t0 = time.perf_counter()
    _, drift, obs = evolve_ensemble_final(
        sysb, ph0, args.dt, args.steps,
        method=method, iters=(2, 1) if args.fused else 3,
        drift_every=args.steps, observable=swing, obs_every=10,
    )
    amp = obs["max"].double().cpu().numpy()
    wall = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in kernels.launch_counts().items()
                if v != launches0[k]}
    max_drift = float(drift.max())
    rate = b * args.steps / wall
    print(f"[sweep] B={b} × {args.steps} steps (dt={args.dt}, {method}, "
          f"{str(dtype)[6:]}): {wall:.3f}s, {rate:.6e} member-steps/s, "
          f"max |ΔH/H₀| = {max_drift:.6e}, kernel launches {launches}")

    # ---- report --------------------------------------------------------
    k_np = k_grid.double().cpu().numpy()
    i_pk = int(np.argmax(amp))
    k_pk = k_np[i_pk]
    med = float(np.median(amp))
    print(f"\nswing amplification max|θ| over k/k_res ∈ "
          f"[{k_np[0] / k_res:.2f}, {k_np[-1] / k_res:.2f}]  "
          f"(k_res = 3mg/l₀ = {k_res:.2f}):")
    lo, hi = float(amp.min()), float(amp.max())
    cols = min(b, 72)
    idx = np.linspace(0, b - 1, cols).astype(int)
    line = "".join(
        RAMP[int((amp[i] - lo) / max(hi - lo, 1e-12) * (len(RAMP) - 1))]
        for i in idx
    )
    print(f"  k: {k_np[0]:6.2f} {line} {k_np[-1]:6.2f}")
    print(f"  peak max|θ| = {amp[i_pk]:.3f} rad at k = {k_pk:.2f} "
          f"(k/k_res = {k_pk / k_res:.4f}); median over sweep = {med:.3f}")
    results.update(members=b, steps=args.steps, seconds=wall, member_steps_per_sec=rate,
                   max_drift=max_drift, launches=launches, peak_k_over_k_res=k_pk / k_res,
                   peak_amplitude=float(amp[i_pk]), method=method, dtype=str(dtype)[6:])

    ok = abs(k_pk / k_res - 1.0) < 0.25 and amp[i_pk] > 5.0 * args.theta0
    if not ok:
        print("[check] FAILED: resonance peak not where 2:1 theory puts it")
        return 1
    print("[check] autoparametric 2:1 resonance confirmed at k ≈ 3mg/l₀")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
