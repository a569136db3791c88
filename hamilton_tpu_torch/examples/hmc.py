#!/usr/bin/env python
"""Hamiltonian Monte Carlo on the port's symplectic library path.

The port of ``examples/hmc.py``.  HMC (Duane et al.; Neal, "MCMC using
Hamiltonian dynamics", arxiv 1206.1901) is Hamiltonian simulation:
proposals integrate H(q, p) = ½ pᵀK⁻¹p + U(q) with a leapfrog and accept
with min(1, exp(−ΔH)), so the acceptance rate is a direct function of the
integrator's energy error.

B parallel chains run as one ensemble:

* the target density π(q) ∝ exp(−U(q)) is a Cartesian ``System`` (identity
  coordinate map, unit inertia, ``U = ½ qᵀ P q`` with the precision matrix P
  in ``System.params``);
* each iteration (:func:`hmc_iteration`) refreshes p ~ N(0, I) and
  integrates L leapfrog steps on the batch-native stepper
  (``make_stepper("leapfrog", iters=(1, 1))``, (B, n) states; for this
  separable H the generalized-Verlet fixed points are exact at (1, 1));
  with no mass matrix given the system takes the J route, so on the card
  each step factors K from √M·J (K2e) and solves with the factor (K2c), and
  ``hamiltonian`` supplies ΔH for the Metropolis test (K2d);
* the draws come from an explicit ``torch.Generator`` seeded from
  ``--seed``; the run is an eager loop in float32, as the reference's (which
  never enables x64).

Validation (exit 0): the sample covariance of the pooled post-warmup draws
matches the analytic Σ = P⁻¹ entrywise, the mean is near 0, and the
acceptance rate sits in the healthy band.

Usage:
    python -m hamilton_tpu_torch.examples.hmc                 # on the card
    python -m hamilton_tpu_torch.examples.hmc --chains 256 --iters 500
    ... --device cpu                                          # on the CPU
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from hamilton_tpu_torch.integrators.fixed import make_stepper
from hamilton_tpu_torch.mechanics import hamiltonian
from hamilton_tpu_torch.state import Phase
from hamilton_tpu_torch.system import mk_system_cart

#: The target: a 3-D zero-mean Gaussian with strong correlation.
COV = np.array([
    [1.0, 0.8, 0.3],
    [0.8, 1.5, 0.5],
    [0.3, 0.5, 0.8],
])


def gaussian_system(device, dtype=torch.float32):
    """The target density as a Cartesian system: identity coordinates, unit
    inertia, ``U = ½ xᵀ P x`` with ``P = Σ⁻¹`` in the params."""
    n = COV.shape[0]

    def coords(q, params):
        return q

    def potential(x, params):
        p_mat = params["prec"].to(x.dtype)
        return 0.5 * torch.einsum("...i,ij,...j->...", x, p_mat, x)

    return mk_system_cart(
        torch.ones(n), coords, potential, device=device, dtype=dtype, n=n,
        name="hmc-gaussian", params={"prec": torch.tensor(np.linalg.inv(COV))},
    )


def hmc_iteration(system, stepper, q, p0, u, dt, L):
    """One HMC iteration on every chain: from positions ``q`` (B, n) with the
    momentum draw ``p0`` (B, n) and the uniform draw ``u`` (B,), ``L``
    leapfrog steps of ``dt``, then the Metropolis test.  Returns the new
    positions and the acceptance mask."""
    ph0 = Phase(q, p0)
    h0 = hamiltonian(system, ph0)
    carry = stepper.init(ph0)
    for _ in range(L):
        carry = stepper.step(carry, dt)
    ph1 = stepper.extract(carry)
    dh = hamiltonian(system, ph1) - h0
    accept = u < torch.exp(-dh)
    return torch.where(accept[:, None], ph1.q, q), accept


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=64)
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--leapfrog-steps", type=int, default=16)
    ap.add_argument("--dt", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cov-tol", type=float, default=0.2)
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("hmc: no CUDA device; pass --device cpu to run on the CPU")
    dtype = torch.float32
    n = COV.shape[0]
    system = gaussian_system(device, dtype)
    # identity coords + unit masses: K = I, H separable, so the (1,1)
    # generalized-Verlet fixed points are exact textbook leapfrog
    st = make_stepper(system, "leapfrog", iters=(1, 1))
    dt = torch.tensor(args.dt, dtype=dtype, device=device)
    L, B = args.leapfrog_steps, args.chains
    gen = torch.Generator(device=device).manual_seed(args.seed)

    q = torch.randn((B, n), generator=gen, dtype=dtype, device=device)
    qs, accepts = [], []
    for _ in range(args.iters):
        p0 = torch.randn((B, n), generator=gen, dtype=dtype, device=device)  # K = I
        u = torch.rand((B,), generator=gen, dtype=dtype, device=device)
        q, accept = hmc_iteration(system, st, q, p0, u, dt, L)
        qs.append(q)
        accepts.append(accept)

    acc = float(torch.stack(accepts[args.warmup:]).float().mean())
    draws = torch.stack(qs[args.warmup:]).reshape(-1, n).double().cpu().numpy()
    mean = draws.mean(axis=0)
    sample_cov = np.cov(draws.T)
    cov_err = np.max(np.abs(sample_cov - COV))

    print(f"chains={B} iters={args.iters} L={L} dt={args.dt}")
    print(f"acceptance rate: {acc:.3f}")
    print(f"posterior mean:  {np.array2string(mean, precision=3)} (true 0)")
    print("sample cov vs true (max abs err "
          f"{cov_err:.3f}, tol {args.cov_tol}):")
    print(np.array2string(sample_cov, precision=3))

    ok = (0.6 <= acc <= 0.999) and cov_err < args.cov_tol and (
        np.max(np.abs(mean)) < 0.15
    )
    if not ok:
        print("FAIL: sampler statistics out of tolerance")
        return 1
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
