#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout; needs one card

Builds the hand-written kernels (``hamilton_tpu_torch/csrc/fused_step.cu``,
``csrc/chain_variants.cu``, ``csrc/family_step.cu``, ``csrc/semisep_wide.cu``,
``csrc/batched_spd.cu`` and ``csrc/roofline_probes.cu``, one nvcc each or one
a part, and
``csrc/user_family_step.cu`` around the generated forms of the elastic
pendulum and a 3-point Bézier, all at once, and beside them and phases
1-20 the kernels of phase 21's chain cases), then runs these phases and
raises as soon as one fails:

1. kernel against its plain PyTorch version: one 50-step call on a ragged
   batch of 1000 members, chain-20 (semiseparable, ``(2,0)``, Kahan) and the
   double pendulum (dense, ``(2,1)``), each in float64 and float32; the
   semiseparable form at chain-20 and chain-5 with shared and per-member
   tables, plain and ``suzuki4``, on 1000, 1, 7 and 16383 members, each in
   float64 and float32 (the cases that differ only in their batch share one
   plain run on their members put together, each kernel run held against
   its slice); the one-thread dense chain (``DENSE_SMALL``): the double
   pendulum with per-member masses on 1000, 1, 7 and 16383 members and the
   chain at n = 4 at ``fit_masses``' (3,1), shared and per-member tables,
   on 1000 and 7, each in float64 and float32 (whether equal bit for bit
   logged beside); the chain kernels' float sin/cos, sqrt and reciprocal
   against ``sinf``/``cosf``, ``sqrtf`` and ``1/x`` on every float; and
   each semiseparable kernel's and each one-thread dense part's layout,
   registers and spills;
2. kernel against physics: float64 chain-5 ``(3,2)`` against the port's
   library leapfrog over two steps;
3. the headline: ``evolve_ensemble_chunked`` on 16384 × chain-20, float32,
   ``(2,0)``, Kahan, dt=5e-4, 2e5 steps in chunks of 1e4, 50 steps per
   launch, float64 drift sampled every 1000 steps — exactly one launch per
   50 steps and one float64 K2a solve per drift sample, finite output,
   ``max|ΔH/H₀| < 1e-6``;
4. the double pendulum: 16384 members, float32, ``(2,1)``, dt=1e-3, 1e4
   steps through ``evolve_ensemble_final`` without drift tracking, called
   20 times back to back so the timed window spans a few hundred ms;
5. the plain version's time beside the kernel's for one 50-step call at the
   shapes of phases 3 and 4, with their agreement; the kernel's device time
   per launch (launches queued behind a held stream) and the host's time to
   issue one;
6. control: the headline run again without Kahan compensation, whose drift
   must exceed the bound of phase 3 — so that bound can see a kernel that
   loses the compensation;
7. the five batched tiny-SPD kernels (K2a-K2e) against their plain versions
   on B=1000, 4097 and 16384 at n = 1, 2, 3, 20, 32 in float32 and float64
   (random SPD K, and √M·J with m = 2n and m = n, from a seed), bit for
   bit, and each kernel's device time at 16384 × 20 (m = 40; on one operand
   set, and on four in turn) beside its plain version's and one PyTorch
   call's, and K2d's at 16384 × n = m = 3 in float64 (spring's shape); then
   in bfloat16 (a storage type: the kernels widen to float32, run the
   float32 member chain and round once, as the plain versions do): each
   entry against its plain version bit for bit on B=1000, 4097 and 16384 at
   n = 3, 20, 32 (J at m = 2n and m = n), the bf16 library path (a leapfrog
   (2,0) of 16384 × chain-20 on the K route and on the J route, one
   ``ham_eqs`` on each) with its exact launches, and each entry timed at
   16384 × 20 beside its plain version, the float32 entry and the PyTorch
   call where ``torch.linalg`` takes bf16 on the card;
8. adaptive GSL-RKF45 ``evolve_ham`` at full width (``bench.py::
   phase_adaptive``): 16384 × chain-20, one shared controller over t ∈ [0, 1],
   float64 at GSL's eps and float32 at eps 1e-6 — exactly six K2a launches
   per attempt, not saturated, finite, and in float64 ``max|ΔH/H₀|`` under
   the bound taken from the JAX package's CPU run;
9. (a) that adaptive path on the card (the kernels) against the CPU (the
   plain versions): 8 members, float64, shared and per-member controllers —
   agreement to 1e-12 and the same step counts; then the native C++ engine
   (``hamilton_tpu_torch.native``, ``native/hamode.cpp`` built here, which
   must load) as the oracle: (b) the parity triangle of the double pendulum
   (the port's ``evolve_ham`` on the card, the engine driving the port's
   ``ham_rhs`` on the card, the engine's closed form) pairwise within 1e-9;
   (c) 8 members of phase 8's float64 final states against the engine's
   closed-form chain at eps 1e-13, each within 10x the JAX package's own
   gap on the CPU (``ORACLE_CHAIN20_BOUND``);
10. the library leapfrog at full width: ``evolve_ensemble_final(method=
    "leapfrog", iters=(2, 0), compensated=True)`` on 16384 × chain-20,
    float32, 2000 steps, float64 drift every 1000 — one K2b and five K2c
    launches per step; then 50 steps under ``torch.profiler`` for the
    card's busy share;
11. the J route at full width: a 20-link chain given by its coordinate map
    and potential alone (no analytic Jacobian or mass matrix), 200 library
    leapfrog steps on 16384 members in float32 (K2e, K2c; K2d in its float64
    drift samples), then 50 steps under ``torch.profiler`` for the card's
    busy share, and ``evolve_ham`` of 16384 springs in float64 over 10
    output intervals (K2d); each against the CPU on a 1000-member slice;
12. the roofline path (``bench.py::phase_roofline``): the probe kernels
    K3a-K3c against their plain versions on small random inputs at every
    layout the sweep can pick, then the card's float32 FMA, ``sinf`` and
    device-memory ceilings at the reference's probe sizes (the per-thread
    chain count and the block count swept, the best kept), a check that the
    probe times grow linearly with their repetitions (nothing folded), each
    probe at that size and its best layout against its plain version on
    random inputs, the port's ``fused_step_cost`` of the headline and its
    achieved flop and sin shares;
13. the sweep (``bench.py::phase_sweep``): per-member masses and gravity
    from ``numpy.random.default_rng(7)`` on 16384 × chain-20, the per-member
    kernel against its plain version over one 50-step launch and (float64
    chain-5 (3,2)) against the library leapfrog, then 2e5 steps at dt=5e-4
    through ``evolve_ensemble_chunked`` — exactly 4000 K1 and 201 K2a
    launches, ``max|ΔH/H₀| < 1e-6``;
14. order 4 (``bench.py::phase_margin``): ``suzuki4_fused`` (2,0), the
    kernel against its plain version over one launch, then 1e5 steps at
    dt=1e-3 — exactly 2000 K1 and 101 K2a launches, ``max|ΔH/H₀| < 1e-6``;
15. the model families (``bench.py::phase_families``) on K1's family
    kernel (``csrc/family_step.cu``): (a) each family's kernel against its
    plain version on 16384 members over a 5-step launch, float32 (2,0)
    Kahan and float64 (3,2), plus the two-body sweep (per-member m1, m2)
    and ``suzuki4_fused`` on the spherical pendulum; (b) each against the
    library leapfrog, float64 (3,2), 1000 members, 2 steps; (c) each at
    16384 members, float32 (2,0) Kahan, 50 steps a launch, over t = 100 at
    its dt, float64 drift every 1000 steps — exact launch counts, finite
    states, ``max|ΔH/H₀| < 1e-6`` for the spherical pendulum, the spring
    and two-body in float64 (also run), the other drifts recorded; (d) the
    spherical pendulum's and two-body's fused rate against the library
    leapfrog's (200 steps); (e) each family's 50-step launch timed, with
    its plain version, the host's issue and its bound;
16. the chain's other forms (``bench.py --fused-solver``) on K1's
    chain-variant kernel (``csrc/chain_variants.cu``), Möbius and L⁻¹ each:
    (a) the kernel against its plain version on 16384 × chain-20 over a
    5-step launch, float32 (2,0) Kahan and float64 (3,2), shared and
    per-member (phase 13's) tables, and ``suzuki4_fused``, then on ragged
    batches of 1, 7 and 16383 members: bit for bit; (b) against the
    semiseparable kernel over one 50-step launch; (c) float64 (3,2) against
    the library leapfrog on chain-20 and chain-5, 1000 members, 2 steps;
    (d) the headline's run on this form — exactly 4000 K1 and 201 K2a
    launches, ``max|ΔH/H₀| < 1e-6``; (e) the 50-step launch at n = 20 and
    n = 5 timed, with its plain version, the host's issue and its bound,
    and for L⁻¹ its lanes a member, shared memory a block and warps an SM
    as the library reports them, registers and spills;
17. gradients at full width: (a) each K2 entry's gradient at 16384 × n=20
    in float32 and float64 against autograd through the plain masked
    Cholesky and triangular solves, a solve's backward launching its kernel
    exactly once; (b) float64 (3,2) on 16384 × chain-20: the gradient of a
    final-state loss with respect to (q₀, p₀) and the 20 shared masses
    through one ``GRAD_STEPS``-step fused launch (the kernel forward, the
    replay backward) against as many library-leapfrog steps (backward on
    K2) to 1e-9 relative, and against a central difference on one mass;
    (c) float32
    (2,0) Kahan: the forward and backward ms of one 50-step launch and the
    peak memory; (d) ``fit_masses --fused`` on the card, cut to
    ``FIT_ITERS`` Adam iterations and gated on its loss falling tenfold,
    and the dense n = 4 launch it runs, timed;
18. a user's own family on K1's generated kernel (``csrc/
    user_family_step.cu`` around the header ``ops/fused_codegen.py`` makes
    from the family's forms, built beside the other sources): (a) the
    generated kernel against its plain version, bit for bit, on the
    elastic pendulum (``hamilton_tpu_torch/examples/elastic_pendulum.py``)
    and a 3-point Bézier at 16384 members over a 5-step launch, float32
    and float64, compensated or not, on the float64 constant table, a
    run-time shared table and a per-member one, plain and
    Suzuki-composed; PyTorch's division by a Python float on the card (a
    product with the reciprocal, which the generated code follows); (b)
    the float64 kernel against the library leapfrog, 1024 members, 2 steps,
    ≤ 1e-11; (c) other parameter values build nothing; (d) the example's
    ``main(["--fused", "--sweep", "16384", "--device", "cuda"])`` at its
    defaults (12000 steps, dt = 5e-3, float32 (2,1), per-member spring
    constants, ``RunningExtrema`` every 10 steps, one drift sample at the
    end): it must return 0 (the resonance peak within 25 % of k_res), with
    exactly 12002 K1 launches (2 in its parity stage) and nothing else;
    (e) the 3-point Bézier as a family cell (16384 members, float32 (2,0)
    Kahan, t = 100, 50 steps a launch); (f) each one's launch timed at its
    run's shape, with its plain version, the host's issue and its bound;
19. the fixed-step default, ``gauss4``, on the library path
    (``bench.py::phase_drift``'s configuration): (a) ``evolve_ensemble_final
    (method="gauss4", iters=6, drift_every=1000)`` on 1024 × chain-20,
    float64, dt = 1e-3, jittered as ``bench.py::_build`` (seed 0), cut to
    1000 steps (one drift sample) from the bench's 1e5 — exactly 1 + iters
    K2a launches a step
    (its two stages folded into one 2048-member solve) and one a drift
    sample, nothing else, finite output, ``max|ΔH/H₀| < 1e-12``; K2a timed
    at that stage shape (2048 × n = 20, float64) beside its plain version
    and one PyTorch call; (b) every library fixed-step method (``rk4``,
    ``midpoint``, ``gauss4``, ``gauss6``, ``yoshida4`` at (2,0), ``tao2``,
    ``tao4``) on 8 members of chain-20, float64, 20 steps, and ``gauss4`` on
    the J-route chain (K2d), also as a sweep over per-member inertia through
    ``evolve_ensemble(system_batched=True)``: the card's kernels against the port's plain
    versions on the CPU to 1e-12, each with its exact launch counts; (c)
    the gradient through 5 gauss4 steps against the CPU's to 1e-9
    relative, with and without ``remat`` (each solve's backward one more
    K2a launch, remat's recompute one more a solve), and the backward's
    peak memory at 1024 members.  (a)-(c) run in a second process on the
    card, started after the build beside phase 1 (both host-bound on one
    core; phase 1 times nothing) and waited for before phase 2; phase 19
    prints their log and times, in this process, the host's ms a gauss4
    ``ham_eqs`` and K2a at the stage shape;
20. the tools and examples (``hamilton_tpu_torch/examples/``, ``cli``,
    ``utils``): (a) ``chaos_scan.main(["--fused", "--cols", "128", "--rows",
    "64"])`` — 16384 pair members, 4000 steps at 40 a launch: exit 0 and
    exactly 100 K1 launches and nothing else, its first launch against the
    plain version within ``TOL``'s float32 limits, K1 timed at that shape;
    (b) ``ensemble_sweep.main(["--method", "leapfrog_fused", "--batch",
    "16384", "--steps", "20000", "--mass-grid", "8", "--json"])``
    (BASELINE configs[4]'s size, per-member m₂): exactly 2 × 20000 K1
    launches (one step a launch, the run and its twin), finite λ and drift,
    its member-steps/s; (c) in the second process after phase 19's checks,
    host-bound, rates recorded and never claimed: the sweep at its gauss4
    default on 16384 members cut to ``SWEEP_GAUSS4_STEPS``, ``hmc.main`` at
    16384 chains × 100 iterations with its exact K2e, K2c and K2d launches,
    and the CLI headless (``doublepend`` 12 frames and chain-20 3 frames at
    ``rkf45``, ``--method gauss4 doublepend``), each final state against the
    same run on the CPU to 1e-12 with its seconds a frame; (d) a Poincaré
    section of a 16384-member float64 trajectory on the card against the
    CPU's (1e-12, the same mask), a 50-step guarded fused loop under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host read until
    ``checked`` returns; a poisoned member raises naming its step), and a
    checkpoint of the fused carry saved from the card and resumed bit for
    bit; and hmc's K2 kernels timed at its shape;
21. (a) K1's chain cases at the reference's default chain (dense n = 20,
    ``anchor21``: (2,1), dt = 1e-3, 2000 steps) and its stress chain
    (``System 40 20``: semiseparable (2,0), dt = 5e-4, 2000 steps; dense
    (2,0), 1000 steps), 16384 members, float32 Kahan, 50 steps a launch, on
    the kernel ``KERNEL_INSTANTIATIONS`` routes each to (the dense chain on
    G lanes a member, ``csrc/fused_step.cu``'s parts of
    ``csrc/dense_lanes.cuh``; the semiseparable one at n = 40 on
    ``csrc/semisep_wide.cu``; or the generated kernel; built beside the
    first build and phases 1-20): its nvcc seconds, layout, registers, stack
    frames and spills; the kernel against its plain version at 1000 and 7
    members in float64 and float32 (bit for bit on the hand-written ones;
    dense n = 40 over a 10-step launch), the dense n = 20 lanes with a
    per-member table and with a composition on 37 members and the
    semiseparable n = 40 kernel in those modes on 1000 and 7, bit for bit
    (these checks time nothing and run at the end of phase 1, beside phase
    19's checks);
    the run through ``evolve_ensemble_final`` with its exact launches,
    member-steps/s and ``max|ΔH/H₀|`` sampled in float64 every 1000 steps
    (< 1e-6 for dense n = 20 and semiseparable n = 40, dense n = 40's
    recorded); the 50-step launch timed beside its plain version, its bound
    and share; (b) ``evolve_ensemble_sharded`` on the headline's
    configuration (2000 steps) on a one-device mesh and 4 shards on the card
    (and over every card where there are more): final state and per-member
    drift bitwise ``evolve_ensemble_final``'s, exactly 40 K1 launches a
    shard; ``reduce_stats`` max and mean through a world-size-1 NCCL group
    that ``init_distributed`` opens on localhost; the dense chain-20 on 4
    shards; a ``save_orbax``/``load_orbax`` (DCP) round trip of the 4
    shards, bitwise.

Every kernel's row gives its launches on its main path, its device time
and its plain version's, the bound (the larger of its operations over the
published float32/float64 peak and its bytes over the published memory
rate, from this run's shapes; ``hamilton_tpu_torch.utils.roofline.bound``)
and the time of one PyTorch call that computes the same function, where
there is one.  Prints the card's name and power limit, the CUDA version,
the build times and nvcc's register/spill report, one JSON line describing
the kernels, and as its last line ``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""

from __future__ import annotations

import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Tolerances of the kernel against its plain version (phases 1 and 5).  The
# kernel runs the plain version's operations in the same order; nvcc
# contracts a*b+c into FMAs (one rounding instead of two) and libdevice's
# sin/cos may differ from PyTorch's by an ulp, so the two agree to an ulp or
# two, accumulated over 50 steps.  Both sides are deterministic, so each
# limit sits about 10x above the largest reading on an H100 80GB HBM3
# (given in brackets, float64 / float32):
#   q, p — absolute; |q| ~ 0.5-1.6 and |p| ≲ 10  [2.2e-16 / 1.2e-7];
#   q+cq, p+cp — the compensated sums, absolute: the differences
#     (q_k − q_p) + (cq_k − cq_p) taken in float64  [3.5e-17 / 3.0e-8].
#     A kernel that lost the compensation would miss them by the rounding
#     it drops, ~sqrt(50) ulps of |p| ≲ 10 in float32 (~1e-6);
#   a_est, the warm-start force (|a| up to ~50) — relative to its largest
#     magnitude  [2.8e-16 / 1.5e-7];
#   vdot_est = (v1 − v0)/dt, the warm-start velocity derivative — relative
#     [2.0e-11 / 1.1e-2].  Its numerator is a difference of two velocities,
#     each good only to ~cond(K)·eps relative (chain-20's mass matrix is
#     ill-conditioned), and 1/dt = 2000 amplifies that.  It enters the next
#     step only through the dt²/2 term of the q-predictor, where that error
#     is below float32 resolution.
TOL = {
    "float64": {"abs": 2e-15, "kahan": 4e-16, "a_est": 3e-15, "vdot_est": 2e-10},
    "float32": {"abs": 1e-6, "kahan": 3e-7, "a_est": 2e-6, "vdot_est": 5e-2},
}
# Phase 1's vdot_est limits for the semiseparable chain-5 rows (every other
# limit is TOL's, which were read at chain-20).  Chain-5's vdot_est differs
# from the plain version's by more, relative to its largest magnitude, in
# the one-thread kernel before its straight-line sin/cos, sqrt and 1/x as
# after: on an H100 80GB HBM3 the largest readings over phase 1's rows on the
# same inputs (scripts/torch_ab.py --accuracy) were 4.073e-10 / 1.737e-1
# (float64 / float32) before and 4.073e-10 / 1.646e-1 after.  Each limit
# sits about twice above them, as TOL's vdot_est limits do at chain-20.
CHAIN5_VDOT = {"float64": 1e-9, "float32": 3e-1}
# the fused step against the library leapfrog at converged (3,2) iterations:
# the same fixed points through different linear algebra, float64 rounding
PHYSICS_TOL = 1e-12
# the reference's bound on the headline drift
DRIFT_BOUND = 1e-6
# the bench's ensemble size, headline horizon and double-pendulum horizon
# (bench.py:1155, bench.py:1153-1208, bench.py:1062)
BATCH = 16384
HEADLINE_STEPS = 200_000
DP_STEPS = 10_000
DP_REPEATS = 20
REPLACES = "hamilton_tpu/ops/pallas_step.py:585"
SOURCE = "hamilton_tpu_torch/csrc/fused_step.cu"
DENSE_SOURCE = "hamilton_tpu_torch/csrc/dense_lanes.cuh"
K2_SOURCE = "hamilton_tpu_torch/csrc/batched_spd.cu"
# The K2 kernels compute their plain versions' IEEE operations in the same
# order (round-to-nearest intrinsics, never fused into an FMA), so the two
# agree bit for bit: every reading on an H100 80GB HBM3 was 0, and the limit
# is equality.  A nonzero difference means the kernel no longer does the
# plain version's arithmetic.
K2_TOL = 0.0
K2_SIZES = (1, 2, 3, 20, 32)
# 4097: a batch that is not a multiple of any tile's members (K2b, K2c)
K2_BATCHES = (1000, 4097, BATCH)
# operand sets the K2 kernels are also timed on in turn, 26 MB or more each
# at 16384 x 20: their time when the 50 MB L2 does not hold the operands
K2_ROTATE = 4
# The kernels line's K2 rows, (entry, n, m, dtype), each at a shape and
# dtype its main path runs: n = 20, the adaptive float64 run and the
# headline's drift sampler (K2a), the float32 library leapfrog (K2b, K2c),
# the J-route leapfrog (K2e, m = 40) and its float64 drift sampler (K2d);
# n = m = 3, spring's float64 evolve_ham (K2d).
K2_ROWS = (("spd_solve_batched", 20, 0, "float64"), ("cholesky_batched", 20, 0, "float32"),
           ("cho_solve_batched", 20, 0, "float32"), ("spd_solve_jac", 20, 40, "float64"),
           ("spd_solve_jac", 3, 3, "float64"), ("cholesky_jac", 20, 40, "float32"))
# bfloat16 K2 (phase 7): the entries widen bf16 to float32, run the float32
# member chain and round each result once, as their plain versions do, so
# the two are equal bit for bit (K2_TOL) at these n; the kernels line's bf16
# rows at the float32 rows' shapes (16384 x 20, m = 40), with the launches
# of a bfloat16 library leapfrog on each route (BF16_STEPS steps of 16384 x
# chain-20, K route K2b/K2c and J route K2e/K2c) and one ham_eqs on each
# (K2a, K2d)
K2_BF16_SIZES = (3, 20, 32)
K2_BF16_ROWS = (("spd_solve_batched", 20, 0), ("cholesky_batched", 20, 0),
                ("cho_solve_batched", 20, 0), ("spd_solve_jac", 20, 40), ("cholesky_jac", 20, 40))
BF16_STEPS = 10
# Adaptive float64 at GSL's eps: the JAX package's CPU run of the same
# configuration at 64 members read max|ΔH/H₀| = 8.22e-9 (75 attempts);
# the bound allows 12x that for the max over 16384 members.
ADAPTIVE_DRIFT_BOUND = 1e-7
GSL_EPS = 1.49012e-08
ADAPTIVE_F32_EPS = 1e-6
# Card against CPU in float64 (phases 9 and 11): the same arithmetic except
# PyTorch's sin/cos/exp and reductions, which differ by ulps between the two;
# readings ≲ 7e-14 on |p| ≤ 38 over t ≤ 1.
CPU_TOL_F64 = 1e-12
# The native C++ engine (hamilton_tpu_torch.native) as the oracle of phase
# 9: (b) the parity triangle of tests/test_native.py (the double pendulum at
# q0 = (1, 0), v0 = (0, 0.5), t = 0, 0.1, ..., 1) pairwise within its 1e-9;
# (c) ORACLE_MEMBERS members spread over phase 8's float64 batch (jittered
# with ADAPTIVE_SEED) against its closed-form chain at eps ORACLE_EPS.  The
# bound is 10x the gap of the JAX package's own evolve_ham on those members
# on the CPU, 5.916067e-7 (tests/test_torch_native.py::
# test_chain20_gap_sets_the_card_bound, which holds this constant to it).
TRIANGLE_TOL = 1e-9
TRIANGLE_TS = tuple(round(0.1 * k, 1) for k in range(11))
ADAPTIVE_SEED = 0
ORACLE_MEMBERS = 8
ORACLE_EPS = 1e-13
ORACLE_CHAIN20_BOUND = 5.916067e-6
# Card against CPU in float32 over 20 leapfrog steps of the J route: ulps of
# sin/cos through chain-20's K; the reading is 6.0e-8 (one ulp of |q| ~ 0.5).
CPU_TOL_F32 = 6e-7
LEAPFROG_STEPS = 2000
# steps of the library leapfrog under torch.profiler for the card's busy share
BUSY_STEPS = 50
J_STEPS = 200
# the sweep and order-4 paths (bench.py:568-610 with ROADMAP's 2e5-step
# horizon at dt=5e-4; bench.py:539, the suzuki4_fused datapoint)
SWEEP_STEPS, SWEEP_DT = 200_000, 5e-4
ORDER4_STEPS, ORDER4_DT = 100_000, 1e-3
# the probes against their plain versions: K3a does one single-rounding FMA
# a rep on both sides, and K3c one add, so both are equal bit for bit; K3b
# is the straight-line sinf (sinf itself outside its range) against
# PyTorch's float32 sin on the card (every reading on an H100 80GB HBM3 has
# been 0: sinf bit for bit, csrc/libm_check.cu), and the limit allows a few
# ulps of (0, 1) from a differing sin
K3_TOL = {"fma_probe": 0.0, "sin_probe": 1e-6, "add_one": 0.0}
# the probe sweeps: per-thread chains x block size for K3a/K3b, blocks of
# 256 threads for K3c (132 SMs; 131072 blocks give each thread one float4)
PROBE_ILP = (4, 8, 16, 32)
PROBE_BLOCKS = (128, 256)
HBM_BLOCKS = (528, 1056, 2112, 8448, 33792, 131072)
PROBE_SOURCE = "hamilton_tpu_torch/csrc/roofline_probes.cu"
# the families path (bench.py::phase_families, :639-730): t = 100 at each
# family's dt (FAMILY_DT, bench.py:620-625; ellipse and Bézier were never
# calibrated and run at the smallest calibrated dt), 50 steps a launch,
# float64 drift samples every 1000 steps; the library leapfrog it is set
# against, cut to 200 steps (its per-step cost is what is compared)
FAMILY_HORIZON = 100.0
FAMILY_SPC = 50
FAMILY_DRIFT_EVERY = 1000
FAMILY_LIBRARY_STEPS = 200
FAMILY_SOURCE = "hamilton_tpu_torch/csrc/family_step.cu"
BEZIER2_POINTS = ((-1.0, -1.0), (1.0, 1.0))
# the family codes of csrc/family_step.cu, for its ptxas report
FAMILY_CODES = ("spherical", "two_body", "room", "spring", "ellipse", "bezier 5 points",
                "bezier 2 points")
PROBE_REPLACES = {"fma_probe": "hamilton_tpu/utils/roofline.py:261",
                  "sin_probe": "hamilton_tpu/utils/roofline.py:304",
                  "add_one": "hamilton_tpu/utils/roofline.py:375"}
# the chain's other forms (bench.py --fused-solver, :1189) on K1's
# chain-variant kernel; the case codes of csrc/chain_variants.cu, for its
# ptxas report
CHAIN_SOLVERS = ("mobius", "linv")
CHAIN_SOURCE = "hamilton_tpu_torch/csrc/chain_variants.cu"
CHAIN_CODES = ("mobius n=20", "mobius n=5", "linv n=20", "linv n=5", "dense n=4")
# a Möbius or L⁻¹ launch against the semiseparable kernel's over 50 steps:
# the same fixed points through other rounding (float64 (3,2); float32
# (2,0) Kahan)
FORMS_TOL = {"float64": 1e-11, "float32": 1e-4}
# batches that are not a multiple of a block's members nor, for L⁻¹, of the
# block's threads: the last block runs part full
RAGGED_BATCHES = (1, 7, 16383)
# the gradient phase: each K2 entry's gradient by its kernel against autograd
# through the plain masked Cholesky and triangular solves, relative to the
# largest entry; the fused gradient against the library leapfrog's (the JAX
# test's 1e-9, tests/test_pallas_step.py:463-466) and a central difference
K2_GRAD_TOL = {"float64": 1e-12, "float32": 1e-4}
GRAD_TOL = 1e-9
FD_RTOL = 1e-5
# the steps of that fused launch and of the library run (the float64 replay
# backward took 79.5 s over 50 steps at 16384 members on an H100 80GB HBM3
# host)
GRAD_STEPS = 10
# fit_masses --fused (1024 members, 24 steps a launch): its backward replays
# the plain step (host-bound, ~2 s an iteration on the card), so the run is
# cut from the example's 200 Adam iterations and gated on its loss falling
# tenfold
FIT_ITERS = 30
# a user's own family on the generated kernel (phase 18): the elastic
# pendulum example at 16384 members and its defaults, and a 3-point Bézier
# (no hand-written instantiation) as a family cell
USER_SOURCE = "hamilton_tpu_torch/csrc/user_family_step.cu"
BEZIER3_POINTS = ((-1.0, -1.0), (0.0, 1.0), (1.0, -1.0))
ELASTIC_STEPS = 12000
ELASTIC_PARITY_TOL = 1e-11
USER_TABLES = ("float64 constant table", "run-time shared table", "per-member table")
# the gauss4 drift run (bench.py::phase_drift, :929-1022: 1024 × chain-20,
# float64, iters=6, dt=1e-3, drift every 1000 steps over 1e5 steps; the
# JAX package read max|ΔH/H₀| = 6.8564e-14 there, BENCH_r05.json:43), cut
# to one drift sample: the library path is host-bound (phase 19 prints the
# host ms a ham_eqs and its ∂T/∂q sweep's; 7 ham_eqs a step), and 2000
# steps took over the phase's 90 s; the bound allows ~15x the reference's
# reading
GAUSS_BATCH = 1024
GAUSS_STEPS = 1000
GAUSS_BENCH_STEPS = 100_000
GAUSS_DT = 1e-3
GAUSS_ITERS = 6
GAUSS_DRIFT_EVERY = 1000
GAUSS_DRIFT_BOUND = 1e-12
# the library fixed-step methods on the card against the CPU: 8 members of
# chain-20 (and the J-route chain for gauss4), float64, 20 steps; the
# gradient through GAUSS_GRAD_STEPS gauss4 steps (GRAD_TOL relative)
# phase 20, the tools and examples: chaos_scan --fused at the bench's
# ensemble size (128 x 64 cells, 16384 pair members; 4000 steps at 40 a
# launch: 100 K1 launches), ensemble_sweep --method leapfrog_fused at
# BASELINE configs[4]'s size (one step a launch, twice: 40000 K1 launches),
# and in the second process the host-bound ones: the sweep at its gauss4
# default on 16384 members, cut from 20000 steps to SWEEP_GAUSS4_STEPS (its
# 7 host-bound ham_eqs a step at n = 2 took 76 ms a step on an H100 80GB
# HBM3 host: 2 x 100 steps, the run and its twin), hmc at
# 16384 chains, and the CLI headless on the card against the CPU
CHAOS_ARGV = ["--fused", "--cols", "128", "--rows", "64", "--device", "cuda"]
CHAOS_LAUNCHES = 100
SWEEP_ARGV = ["--method", "leapfrog_fused", "--batch", "16384", "--steps", "20000",
              "--mass-grid", "8", "--device", "cuda", "--json"]
SWEEP_LAUNCHES = 2 * 20000
SWEEP_GAUSS4_STEPS = 100
HMC_ARGV = ["--chains", "16384", "--iters", "100", "--warmup", "25", "--device", "cuda"]
HMC_ITERS, HMC_L = 100, 16
# (label, argv, frames) of the CLI on the card against the CPU, to
# CPU_TOL_F64; the loop aims at 12 frames a second
CLI_RUNS = (("doublepend rkf45", ["doublepend"], 12), ("chain n=20 rkf45", ["chain"], 3),
            ("doublepend gauss4", ["--method", "gauss4", "doublepend"], 3))
# chaos_scan's first launch against its plain version: TOL's float32 limits
# but the absolute q, p one.  TOL's 1e-6 was read on chain-20 at dt = 5e-4;
# the scan steps dt = 5e-3 with three momentum iterations, and the kernel's
# FMA contractions (one rounding where the plain version takes two) carry
# further through 40 such steps: on an H100 80GB HBM3 the reading was
# 1.431e-6 in p (|q|, |p| ≤ 3.998: six ulps) and 7.15e-7 in q; the limit
# sits about twice above, as CHAIN5_VDOT's do
CHAOS_TOL = dict(TOL["float32"], abs=3e-6)
POINCARE_STEPS, POINCARE_EMIT, POINCARE_CAP = 2000, 10, 24
GUARD_STEPS = 50

GAUSS_CPU_MEMBERS = 8
GAUSS_CPU_STEPS = 20
GAUSS_GRAD_STEPS = 5
# phase 21 (a): K1's chain cases at the reference's default chain (dense,
# n = 20: leapfrog_fused on chain(), the bench's anchor21 datapoint,
# bench.py:549-560) and its stress chain (System 40 20, both forms,
# bench.py:733-806), 16384 members, float32 Kahan, 50 steps a launch,
# float64 drift every 1000 steps: (label, n, fused_solver, iters, dt, steps,
# steps of the launch held against the plain version, drift bound or None
# where it is only recorded).  The dense chain runs on G lanes a member
# (csrc/dense_lanes.cuh), the semiseparable one at n = 40 on
# csrc/semisep_wide.cu (KERNEL_INSTANTIATIONS).  The dense n = 40 plain
# version takes ~0.7 s a step on the card (~10^4 PyTorch operations), so its
# check is a 10-step launch.
CHAIN_CASES = (
    ("dense n=20 (2,1)", 20, "dense", (2, 1), 1e-3, 2000, 50, DRIFT_BOUND),
    ("semiseparable n=40 (2,0)", 40, "semiseparable", (2, 0), 5e-4, 2000, 50, DRIFT_BOUND),
    ("dense n=40 (2,0)", 40, "dense", (2, 0), 5e-4, 1000, 10, None),
)
# the batches each case's kernel is held against its plain version at
CHAIN_CASE_BATCHES = (1000, 7)
# the dense chain at n = 20 and the semiseparable one at n = 40 in their
# other modes, bitwise against the plain version: (fused_solver, n) → (the
# batches, steps a launch), and the modes (label, iters, compensated, swept,
# composition)
MODE_CHECKS = {("dense", 20): ((37,), 5), ("semiseparable", 40): (CHAIN_CASE_BATCHES, 2)}
CHAIN_MODES = (("per-member tables (2,1) kahan", (2, 1), True, True, (1.0,)),
               ("suzuki4 composition (3,1)", (3, 1), False, False, "suzuki4"))
WIDE_SOURCE = "hamilton_tpu_torch/csrc/semisep_wide.cu"
# phase 21 (b): the sharded driver on the headline configuration, 2000 steps
SHARD_STEPS = 2000
SHARD_COUNT = 4


# phase 1's one-thread dense rows (K1's dense chain at n = 2 in
# csrc/fused_step.cu, with FMA contraction, and at n = 4 in
# csrc/chain_variants.cu case 4, without): (n, iters, dt, steps a launch,
# batches, per-member modes) — the double pendulum at phase 4's (2,1) and
# dt, with per-member masses on 1000 members and the ragged batches, and the
# chain at n = 4 at fit_masses --fused' counts, dt and steps, shared and
# per-member; each under TOL, in both dtypes
DENSE_SMALL = ((2, (2, 1), 1e-3, 50, (1000,) + RAGGED_BATCHES, (True,)),
               (4, (3, 1), 1e-2, 24, (1000, 7), (False, True)))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# fused_step_kernel<T, n, semiseparable, compensated, per-member, composed>
# (one thread a member) or lane_kernel<T, n, lanes, compensated, per-member,
# composed, kDenseForm> (the dense chain on lanes, csrc/dense_lanes.cuh)
_KERNEL_RE = re.compile(
    r"(?:fused_step_kernelI(?P<t>[fd])Li(?P<n>\d+)ELb(?P<semi>[01])E"
    r"|lane_kernelI(?P<lt>[fd])Li(?P<ln>\d+)ELi(?P<lanes>\d+)E(?=(?:Lb[01]E){3}Li1E))"
    r"Lb(?P<comp>[01])ELb(?P<pm>[01])ELb(?P<composed>[01])E"
    r"(?:Li(?P<ip>\d+)ELi(?P<iq>\d+)E)?")
# solve_tile_kernel<T, lanes, nmax> (K2a), factor_lanes_kernel<T, lanes, nmax>
# (K2b), substitute_lanes_kernel<T, lanes, nmax> (K2c) (nmax: the one-thread
# form's largest n, 0 on lanes) and jac_tile_kernel<T, lanes, factor lanes,
# nmax, solve> (K2d, K2e)
_K2_RE = re.compile(r"(solve_tile_kernel|factor_lanes_kernel|substitute_lanes_kernel"
                    r"|jac_tile_kernel)I([fd])Li(\d+)E(?:Li(\d+)E)?Li(\d+)E(?:Lb([01])E)?")
_K2_NAMES = {("solve_tile_kernel", None): "spd_solve (K2a)",
             ("factor_lanes_kernel", None): "cholesky (K2b)",
             ("substitute_lanes_kernel", None): "cho_solve (K2c)",
             ("jac_tile_kernel", "1"): "spd_solve_jac (K2d)",
             ("jac_tile_kernel", "0"): "cholesky_jac (K2e)"}


_FAMILY_RE = re.compile(r"family_step_kernelI([fd])Li(\d+)ELb([01])ELb([01])ELb([01])E")
_K3_RE = re.compile(r"(fma_probe_kernel|sin_probe_kernel|add_one_kernel)(?:ILi(\d+)E)?")


def _modes(m):
    ip, iq = m.groupdict().get("ip"), m.groupdict().get("iq")
    # the dense kernels' (iters_p, iters_q) as constants
    counts = f" ({ip},{iq})" if ip not in (None, "0") else ""
    return (f"{' kahan' if m['comp'] == '1' else ''}{' per-member' if m['pm'] == '1' else ''}"
            f"{' composed' if m['composed'] == '1' else ''}{counts}")


def _k1_label(m):
    if m["lt"]:  # the dense chain on lanes
        return f"{'float' if m['lt'] == 'f' else 'double'} n={m['ln']} dense{_modes(m)}"
    return (f"{'float' if m['t'] == 'f' else 'double'} n={m['n']} "
            f"{'semiseparable' if m['semi'] == '1' else 'dense'}{_modes(m)}")


def _family_label(m):
    t, code, comp, per_member, composed = m.groups()
    return (f"{'float' if t == 'f' else 'double'} {FAMILY_CODES[int(code)]}"
            f"{' kahan' if comp == '1' else ''}{' per-member' if per_member == '1' else ''}"
            f"{' composed' if composed == '1' else ''}")


# chain_variant_kernel<T, case, ...> (one thread a member) or
# lane_kernel<T, n, lanes, ...> (L⁻¹)
_VARIANT_RE = re.compile(
    r"(?:chain_variant_kernelI(?P<t>[fd])Li(?P<code>\d+)E"
    r"|lane_kernelI(?P<lt>[fd])Li(?P<n>\d+)ELi\d+E)"
    r"Lb(?P<comp>[01])ELb(?P<pm>[01])ELb(?P<composed>[01])E"
    r"(?:Li(?P<ip>\d+)ELi(?P<iq>\d+)E)?")


def _variant_label(m):
    if m["t"]:
        t, form = m["t"], CHAIN_CODES[int(m["code"])]
    else:
        t, form = m["lt"], f"linv n={m['n']}"
    return f"{'float' if t == 'f' else 'double'} {form}{_modes(m)}"


_USER_RE = re.compile(r"user_family_kernelI([fd])Li(\d)ELb([01])ELb([01])E")
# semisep_wide_kernel<T, compensated, per-member, composed> (csrc/semisep_wide.cu)
_WIDE_RE = re.compile(r"semisep_wide_kernelI(?P<t>[fd])Lb(?P<comp>[01])ELb(?P<pm>[01])E"
                      r"Lb(?P<composed>[01])E")


def _wide_label(m):
    return f"{'float' if m['t'] == 'f' else 'double'} n=40 semiseparable wide{_modes(m)}"


def _user_label(m):
    t, table, comp, composed = m.groups()
    return (f"{'float' if t == 'f' else 'double'} {USER_TABLES[int(table)]}"
            f"{' kahan' if comp == '1' else ''}{' composed' if composed == '1' else ''}")


def _k3_label(m):
    kind, chains = m.groups()
    return f"{kind}{f' chains={chains}' if chains else ''}"


def _k2_label(m):
    kind, t, lanes, factor_lanes, nmax, solve = m.groups()
    name = f"{'float' if t == 'f' else 'double'} {_K2_NAMES[(kind, solve)]}"
    if factor_lanes is not None:  # K2d, K2e: K formed on the lanes
        return (f"{name}, K on {lanes} lanes, factor on "
                + (f"one thread, n <= {nmax}" if factor_lanes == "1" else f"{lanes} lanes")
                + f" (n <= {nmax})" * (factor_lanes != "1"))
    return f"{name}, " + (f"one thread, n <= {nmax}" if lanes == "1" else f"{lanes} lanes")


def ptxas_report(log_text: str, pattern=_KERNEL_RE, label=_k1_label):
    """nvcc's ``-Xptxas -v`` lines per kernel instantiation:
    ``[(name, registers, spill_stores, spill_loads)]``."""
    rows, current, spills = [], None, None
    for line in log_text.splitlines():
        m = pattern.search(line)
        if m and "Compiling entry" in line:
            current = label(m)
            spills = None
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if s and current:
            spills = (int(s.group(1)), int(s.group(2)))
        r = re.search(r"Used (\d+) registers", line)
        if r and current:
            rows.append((current, int(r.group(1))) + (spills or (0, 0)))
            current = None
    return rows


def ptxas_frames(log_text: str, pattern=_KERNEL_RE, label=_k1_label):
    """nvcc's ``-Xptxas -v`` function properties of each function that
    ``pattern`` matches: ``{name: (stack frame, spill stores, spill loads)}``
    in bytes (a factor in local memory shows in the first)."""
    frames, current = {}, None
    for line in log_text.splitlines():
        m = pattern.search(line)
        if m and "Function properties" in line:
            current = label(m)
        s = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if s and current:
            frames[current] = tuple(int(x) for x in s.groups())
            current = None
    return frames


def jittered_phase(example, batch, dtype, device, seed):
    """The bench's initial conditions: the example's initial phase with
    0.01-scale Gaussian jitter on q (members decorrelate), p tiled."""
    import numpy as np
    import torch
    from hamilton_tpu_torch.state import Phase

    ph0 = example.init_phase
    n = ph0.q.shape[-1]
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(seed)
    jitter = 0.01 * rng.standard_normal((batch, n)).astype(np_dtype)
    q = torch.as_tensor(ph0.q.cpu().numpy().astype(np_dtype) + jitter)
    p = ph0.p.cpu().expand(batch, n).contiguous()
    return Phase(q.to(device=device, dtype=dtype), p.to(device))


def oracle_members(batch):
    """The ``ORACLE_MEMBERS`` members of a batch that phase 9 (c) holds
    against the native engine: spread evenly, the first and the last among
    them."""
    import numpy as np

    return np.linspace(0, batch - 1, ORACLE_MEMBERS).round().astype(int)


def family_phase(example, batch, scale, rng, device):
    """``bench.py::phase_families``' initial conditions: the example's
    initial phase in float32 plus ``scale``·N(0,1) in q, drawn from ``rng``
    (the bench shares one generator across its families), p tiled."""
    import numpy as np
    import torch
    from hamilton_tpu_torch.state import Phase

    ph0 = example.init_phase
    n = ph0.q.shape[-1]
    q = ph0.q.cpu().numpy().astype(np.float32) + scale * rng.standard_normal(
        (batch, n)).astype(np.float32)
    p = np.broadcast_to(ph0.p.cpu().numpy().astype(np.float32), (batch, n))
    return Phase(torch.tensor(q, device=device), torch.tensor(p.copy(), device=device))


def semisep_case(dev, n, dtype, batch, swept, composition, seed):
    """Phase 1's semiseparable chain-n at ``batch`` members, (2,0) Kahan:
    its forms, state and (``swept``: per-member masses and gravity from
    ``seed``) table, the state from :func:`jittered_phase`."""
    import numpy as np
    from hamilton_tpu_torch.convert import params_from_numpy
    from hamilton_tpu_torch.models import chain
    from hamilton_tpu_torch.ops.fused_step import fused_stepper

    ex = chain(n_links=n, fused_solver="semiseparable", device=dev, dtype=dtype)
    system = ex.system
    if swept:
        rng = np.random.default_rng(seed)
        system = system.replace_params(params_from_numpy({
            "masses": 1.0 + 0.05 * rng.standard_normal((batch, n)),
            "lengths": np.tile(system.params["lengths"].cpu().numpy(), (batch, 1)),
            "gravity": 5.0 + 0.1 * rng.standard_normal(batch)}, device=dev, dtype=dtype))
    forms = system.fused_forms(system)
    carry = fused_stepper(forms, iters=(2, 0), compensated=True, composition=composition).init(
        jittered_phase(ex, batch, dtype, dev, seed))
    state, table = carry if swept else (carry, None)
    return forms, state, table


def phase1_semiseparable(dev, cases):
    """Phase 1's semiseparable rows: each ``(n, swept, composition, batch)``
    case's kernel against its plain version over one 50-step launch, in
    float64 and float32.  The cases that differ only in their batch share
    one plain run on their members put together (the plain arithmetic is
    member by member, each member's table column with it), and each kernel
    run is held against its slice.  Logs each row; returns the failures."""
    import torch
    from hamilton_tpu_torch.ops.fused_step import fused_step_kernel, fused_step_reference

    groups = {}
    for n, swept, composition, batch in cases:
        groups.setdefault((n, swept, composition), []).append(batch)
    failures = []
    for (n, swept, composition), batches in groups.items():
        label = (f"chain-{n} semiseparable (2,0) kahan{' per-member' if swept else ''}"
                 f"{' suzuki4' if len(composition) > 1 else ''}")
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[-1]
            runs = [semisep_case(dev, n, dtype, batch, swept, composition, 3)
                    for batch in batches]
            kw = dict(iters=(2, 0), compensated=True, composition=composition,
                      steps_per_call=50)
            plain = fused_step_reference(
                runs[0][0], torch.cat([state for _, state, _ in runs], dim=2), 5e-4,
                coef=torch.cat([table for _, _, table in runs], dim=1) if swept else None,
                **kw)
            start = 0
            for batch, (forms, state, table) in zip(batches, runs):
                k_out = fused_step_kernel(forms, state, 5e-4, coef=table, **kw)
                torch.cuda.synchronize()
                _, errs, bad = compare_states(k_out, plain[:, :, start:start + batch], dname,
                                              semisep_tol(n, dname))
                start += batch
                failures.extend(f"{label} {dname} B={batch}: {f}" for f in bad)
                log(f"phase 1 {'FAILED' if bad else 'ok'}: {label} {dname} B={batch} spc=50: "
                    + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return failures


def phase1_dense(dev):
    """Phase 1's one-thread dense rows (:data:`DENSE_SMALL`): each case's
    kernel against its plain version over one launch in float64 and
    float32, under :data:`TOL`; logs each row (and whether it is equal bit
    for bit); returns the failures."""
    import numpy as np
    import torch
    from hamilton_tpu_torch.convert import params_from_numpy
    from hamilton_tpu_torch.models import chain, double_pendulum
    from hamilton_tpu_torch.ops.fused_step import (
        fused_step_kernel, fused_step_reference, fused_stepper,
    )

    failures = []
    for n, iters, dt, spc, batches, modes in DENSE_SMALL:
        for swept in modes:
            for batch in batches:
                for dtype in (torch.float64, torch.float32):
                    dname = str(dtype).split(".")[-1]
                    ex = (double_pendulum(device=dev, dtype=dtype) if n == 2
                          else chain(n_links=n, device=dev, dtype=dtype))
                    system = ex.system
                    if swept:  # per-member masses, the other parameters tiled
                        rng = np.random.default_rng(5)
                        cols = {k: np.broadcast_to(v.cpu().numpy(), (batch,) + tuple(v.shape))
                                for k, v in system.params.items()}
                        cols = {k: v * (1.0 + 0.05 * rng.standard_normal(v.shape))
                                if k in ("m1", "m2", "masses") else v.copy()
                                for k, v in cols.items()}
                        system = system.replace_params(params_from_numpy(cols, device=dev,
                                                                         dtype=dtype))
                    forms = system.fused_forms(system)
                    carry = fused_stepper(forms, iters=iters).init(
                        jittered_phase(ex, batch, dtype, dev, n))
                    state, table = carry if swept else (carry, None)
                    kw = dict(iters=iters, compensated=False, steps_per_call=spc, coef=table)
                    k_out = fused_step_kernel(forms, state, dt, **kw)
                    p_out = fused_step_reference(forms, state, dt, **kw)
                    torch.cuda.synchronize()
                    _, errs, bad = compare_states(k_out, p_out, dname)
                    label = (f"dense n={n} {iters}{' per-member' if swept else ''} {dname} "
                             f"B={batch} spc={spc}")
                    failures.extend(f"{label}: {f}" for f in bad)
                    log(f"phase 1 {'FAILED' if bad else 'ok'}: {label}: bitwise "
                        f"{torch.equal(k_out, p_out)}, "
                        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return failures


def semisep_tol(n, dtype_name):
    """Phase 1's limits of a semiseparable chain-n row."""
    if n == 5:
        return {**TOL[dtype_name], "vdot_est": CHAIN5_VDOT[dtype_name]}
    return TOL[dtype_name]


def compare_states(kernel_out, plain_out, dtype_name, tol=None):
    """Errors of the kernel's state against the plain version's under
    ``tol`` (:data:`TOL`'s for the dtype by default): ``(largest q/p
    absolute error, errors, failures)``.  A compensated state is judged on
    its compensated sums q+cq and p+cp."""
    k, r = kernel_out.double(), plain_out.double()
    diff = k - r
    errs = {"q": diff[0], "p": diff[1]}
    if k.shape[0] == 6:
        errs["q+cq"], errs["p+cp"] = diff[0] + diff[2], diff[1] + diff[3]
    errs["a_est"], errs["vdot_est"] = diff[-2], diff[-1]
    tol = tol or TOL[dtype_name]
    failures = []
    for name, d in errs.items():
        err = float(d.abs().max())
        if name in ("a_est", "vdot_est"):
            err /= max(float(r[-2 if name == "a_est" else -1].abs().max()), 1e-30)
        errs[name] = err
        limit = tol.get(name, tol["kahan" if "+" in name else "abs"])
        if not (math.isfinite(err) and err <= limit):
            failures.append(f"{name} {err:.3e} > {limit:.0e} ({dtype_name})")
    return max(errs["q"], errs["p"]), errs, failures


def time_call(fn, reps):
    """``(device ms per call, last result)`` between CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def reads_back(fn) -> bool:
    """Whether ``fn`` waits for the card (reads a result back to the host):
    called behind a spin kernel, it returns only after the spin has ended."""
    import torch

    torch.cuda.synchronize()
    spun = torch.cuda.Event()
    torch.cuda._sleep(10**8)
    spun.record()
    fn()
    waited = spun.query()
    torch.cuda.synchronize()
    return waited


def counted(fn):
    """``(fn(), counts)``: every launch count set to 0 just before the run
    and read just after it, the card synchronized on both sides."""
    import torch
    from hamilton_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def busy_time(fn):
    """``(device seconds, wall seconds)`` of ``fn()`` under torch.profiler:
    the CUDA kernels' own device time, summed, and the wall time up to a
    synchronize."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / 1e6, wall


def expect_counts(label, counts, **want):
    """Raise unless exactly the ``want`` kernels launched, that often."""
    full = {name: 0 for name in counts}
    full.update(want)
    if counts != full:
        raise AssertionError(f"{label}: launch counts {counts}, expected {full}")


def all_finite(*tensors) -> bool:
    import torch

    return all(bool(torch.isfinite(t).all()) for t in tensors)


def rel_drift(system, first, last):
    """``max|H(last) − H(first)| / max(|H(first)|, 1)`` in float64."""
    import torch
    from hamilton_tpu_torch.mechanics import hamiltonian

    sys64 = system.to(dtype=torch.float64)
    h0 = hamiltonian(sys64, first.astype(torch.float64))
    h1 = hamiltonian(sys64, last.astype(torch.float64))
    return float(((h1 - h0).abs() / h0.abs().clamp(min=1.0)).max())


def generic_chain(n, device, dtype):
    """The n-link chain as a user states it (the reference README's flow):
    a coordinate map and a Cartesian potential, no analytic Jacobian or mass
    matrix, unit masses and lengths, gravity 5 — ``chain(n_links=n)``'s
    physics on the J route."""
    import torch
    from hamilton_tpu_torch.system import mk_system_cart

    def coords(q):
        return torch.cat([torch.cumsum(torch.sin(q), 0), torch.cumsum(1.0 - torch.cos(q), 0)])

    def potential_cart(xs):
        return 5.0 * torch.sum(xs[n:])

    return mk_system_cart(torch.ones(2 * n), coords, potential_cart, device=device,
                          dtype=dtype, n=n, name=f"chain{n} from its coordinate map")


def k2_inputs(batch, n, dtype, device, seed, m=None):
    """Random SPD K (B, n, n), √M·J (B, m, n) (m = 2n unless given) and b
    (B, n) from a seed.  J is the identity on its first n rows plus noise,
    0.3·N(0, 1); at m < 2n the noise is scaled by 1/√n, so that every
    member's K stays well conditioned in float32 (a square J = I + 0.3·G at
    n = 20 is nearly singular in some members of 16384)."""
    import torch
    from hamilton_tpu_torch.ops.batched_spd import jac_scaled

    m = 2 * n if m is None else m
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(batch, n, n, generator=g, dtype=torch.float64)
    k = a @ a.mT + n * torch.eye(n, dtype=torch.float64)
    j = 0.3 * torch.randn(batch, m, n, generator=g, dtype=torch.float64)
    if m < 2 * n:
        j /= n ** 0.5
    j[:, :n] += torch.eye(n, dtype=torch.float64)
    inertia = 1.0 + torch.rand(m, generator=g, dtype=torch.float64)
    b = torch.randn(batch, n, generator=g, dtype=torch.float64)
    k, j, inertia, b = (t.to(device=device, dtype=dtype) for t in (k, j, inertia, b))
    return k, jac_scaled(j, inertia), b


def k2_args(entry, k, js, b):
    """An entry's operands: K, a factor of K (K2c), or √M·J, and b."""
    from hamilton_tpu_torch.ops.batched_spd import cholesky_plain

    src = js if entry.from_jac else (cholesky_plain(k) if entry.name == "cho_solve_batched" else k)
    return (src, b) if entry.solves else (src,)


def k2_work(entry, batch, n, m, dtype):
    """``(operations, bytes)`` of one K2 call on ``batch`` members: the plain
    version's arithmetic counted on counting values (``_chol_entries``,
    ``_solve_entries``; forming K from √M·J takes m products and m − 1 sums
    an entry, j ≤ i), a square root or a division as one operation; each
    input read once and each output written once."""
    import torch
    from hamilton_tpu_torch.ops.fused_step import _chol_entries, _solve_entries
    from hamilton_tpu_torch.utils.roofline import OpCounter

    c = OpCounter(dtype)

    def val(*_):
        return c.value()

    if entry.from_jac:
        for _ in range(n * (n + 1) // 2):
            acc = val() * val()
            for _ in range(m - 1):
                acc = acc + val() * val()
    if entry.name == "cho_solve_batched":
        low = {(i, j): val() for i in range(n) for j in range(i + 1)}
        inv = [1.0 / val() for _ in range(n)]
    else:
        low, inv = _chol_entries(val, n, c.fm.sqrt)
    if entry.solves:
        _solve_entries(low, inv, val, n)
    item = torch.empty((), dtype=dtype).element_size()
    ins = (m * n if entry.from_jac else n * n) + (n if entry.solves else 0)
    outs = n if entry.solves else n * n
    return batch * (c.flops + c.transcendentals), batch * (ins + outs) * item


def k1_bound(system, method, iters, compensated, batch, spc):
    """``(bound ms, term, cost)`` of one K1 launch of ``spc`` steps on
    ``batch`` members: ``fused_step_cost``'s flops and transcendentals (one
    operation each) and its bytes, against the published peaks."""
    from hamilton_tpu_torch.utils.roofline import bound, fused_step_cost

    cost = fused_step_cost(system, method=method, iters=iters, steps_per_call=spc,
                           compensated=compensated, batch=batch, dtype=system.dtype)
    work = batch * spc
    ops = (cost["flops_per_member_step"] + cost["transcendentals_per_member_step"]) * work
    ms, term = bound(ops, cost["bytes_per_member_step"] * work, system.dtype)
    return ms, term, cost


def steady_rate(marks, t0, batch, chunk):
    """Member-steps/s over the chunks after the first, and the first
    chunk's seconds, from the chunk callback's host times."""
    steady = [marks[i] - marks[i - 1] for i in range(1, len(marks))]
    return batch * chunk * len(steady) / sum(steady), marks[0] - t0, len(steady)


def phase_families(dev, entries, summary):
    """Phase 15: the model families on K1's family kernel; appends each
    family's row to ``entries`` and its readings to ``summary``."""
    import numpy as np
    import torch
    from hamilton_tpu_torch.convert import params_from_numpy
    from hamilton_tpu_torch.ensemble import evolve_ensemble_final
    from hamilton_tpu_torch.integrators.fixed import make_stepper
    from hamilton_tpu_torch.mechanics import hamiltonian
    from hamilton_tpu_torch.models import (
        bezier, ellipse, room, spherical_pendulum, spring, two_body,
    )
    from hamilton_tpu_torch.ops.fused_step import (
        SUZUKI4_COMPOSITION, coef_table, fused_step_kernel, fused_step_reference,
        fused_stepper,
    )
    from hamilton_tpu_torch.utils.profiling import time_queued

    t_phase = time.perf_counter()

    # (label, factory, the bench's jitter scale, dt); the 2-point Bézier is
    # the family's other instantiation
    fam_cases = [
        ("spherical", spherical_pendulum, 0.05, 2.5e-4),
        ("twobody", two_body, 0.02, 2.5e-4),
        ("spring", spring, 0.02, 1e-3),
        ("room", room, 0.05, 2.5e-4),
        ("ellipse", ellipse, 0.05, 2.5e-4),
        ("bezier", bezier, 0.05, 2.5e-4),
        ("bezier2", lambda **kw: bezier(BEZIER2_POINTS, **kw), 0.05, 2.5e-4),
    ]
    f32, f64 = torch.float32, torch.float64

    # (a) each family's kernel against its plain version, 16384 members
    rng_a = np.random.default_rng(15)
    fam_err = {}
    fam_checks = []
    for label, make, scale, dt in fam_cases:
        ph_a = family_phase(make(device=dev, dtype=f64), BATCH, scale, rng_a, dev)
        for dtype, iters, comp in ((f32, (2, 0), True), (f64, (3, 2), False)):
            ex = make(device=dev, dtype=dtype)
            fam_checks.append((f"{label} {str(dtype)[6:]} {iters}{' kahan' if comp else ''}",
                               ex.system, ph_a.astype(dtype), iters, comp, (1.0,), dt))
    tb_params = {"m1": 4.0 + rng_a.random(BATCH), "m2": 0.3 + 0.3 * rng_a.random(BATCH)}
    ph_tb = family_phase(two_body(device=dev, dtype=f64), BATCH, 0.02, rng_a, dev)
    for dtype, iters, comp in ((f32, (2, 0), True), (f64, (3, 2), False)):
        sys_tb = two_body(device=dev, dtype=dtype).system.replace_params(
            params_from_numpy(tb_params, device=dev, dtype=dtype))
        fam_checks.append((f"twobody sweep {str(dtype)[6:]} {iters}{' kahan' if comp else ''}",
                           sys_tb, ph_tb.astype(dtype), iters, comp, (1.0,), 2.5e-4))
    ph_sp = family_phase(spherical_pendulum(device=dev, dtype=f64), BATCH, 0.05, rng_a, dev)
    fam_checks.append(("spherical suzuki4 float32 (2, 0) kahan",
                       spherical_pendulum(device=dev, dtype=f32).system, ph_sp.astype(f32),
                       (2, 0), True, SUZUKI4_COMPOSITION, 2.5e-4))
    fam_failures = []
    for label, system, ph_a, iters, comp, composition, dt in fam_checks:
        forms = system.fused_forms(system)
        st = fused_stepper(forms, iters=iters, compensated=comp, composition=composition)
        carry = st.init(ph_a)
        state, table = carry if forms.consts is None else (carry, None)
        kw = dict(iters=iters, compensated=comp, steps_per_call=5, composition=composition,
                  coef=table)
        k_out = fused_step_kernel(forms, state, dt, **kw)
        p_out = fused_step_reference(forms, state, dt, **kw)
        torch.cuda.synchronize()
        dname = str(state.dtype).split(".")[-1]
        worst, errs, failures = compare_states(k_out, p_out, dname)
        fam_failures += [f"{label}: {f}" for f in failures]
        if dname == "float32" and "sweep" not in label and "suzuki" not in label:
            fam_err[label.split()[0]] = worst
        log(f"phase 15 {'FAILED' if failures else 'ok'}: {label} kernel vs plain, B={BATCH} "
            f"spc=5: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if fam_failures:
        raise AssertionError("family kernel disagrees with its plain version: "
                             + "; ".join(fam_failures))

    # (b) each family's kernel against the library leapfrog, float64 (3,2)
    dt_b = torch.tensor(1e-3, dtype=f64)
    for label, make, scale, _ in fam_cases:
        ex = make(device=dev, dtype=f64)
        ph_b = family_phase(ex, 1000, scale, rng_a, dev).astype(f64)
        lib = make_stepper(ex.system, "leapfrog", iters=(3, 2))
        fus = make_stepper(ex.system, "leapfrog_fused", iters=(3, 2))
        c_lib, c_fus = lib.init(ph_b), fus.init(ph_b)
        for _ in range(2):
            c_lib, c_fus = lib.step(c_lib, dt_b), fus.step(c_fus, dt_b)
        a, b = lib.extract(c_lib), fus.extract(c_fus)
        err = max(float((a.q - b.q).abs().max()), float((a.p - b.p).abs().max()))
        log(f"phase 15 {'ok' if err <= PHYSICS_TOL else 'FAILED'}: {label} float64 (3,2) "
            f"kernel vs library leapfrog, 1000 members, 2 steps: {err:.2e}")
        if not err <= PHYSICS_TOL:
            raise AssertionError(f"{label}: family kernel vs library leapfrog {err:.3e}")

    # (c) bench.py::phase_families at full width: t = 100 at each family's dt
    rng = np.random.default_rng(11)  # the bench's generator, drawn in its order
    fam_runs = {}
    for label, make, scale, dt in fam_cases:
        ex32 = make(device=dev, dtype=f32)
        ph_c = family_phase(make(device=dev, dtype=f64), BATCH, scale, rng, dev)
        runs = [(label, ex32.system, ph_c)]
        if label == "twobody":
            runs.append(("twobody float64", make(device=dev, dtype=f64).system,
                         ph_c.astype(f64)))
        for run_label, system, ph_run in runs:
            n_steps = round(FAMILY_HORIZON / dt)
            t0 = time.perf_counter()
            (fin, drift), counts = counted(lambda: evolve_ensemble_final(
                system, ph_run, dt, n_steps, method="leapfrog_fused", iters=(2, 0),
                compensated=True, drift_every=FAMILY_DRIFT_EVERY, drift_dtype=f64,
                steps_per_call=FAMILY_SPC))
            el = time.perf_counter() - t0
            samples = n_steps // FAMILY_DRIFT_EVERY
            want = {"family_step": n_steps // FAMILY_SPC}
            if system.n >= 3:  # the float64 sampler's solve: K2d from n = 3
                want["spd_solve_jac"] = 1 + samples
            expect_counts(run_label, counts, **want)
            if not all_finite(fin.q, fin.p, drift) or tuple(fin.q.shape) != (BATCH, system.n):
                raise AssertionError(f"{run_label}: output not finite or not "
                                     f"({BATCH}, {system.n})")
            sys64 = system.to(dtype=f64)
            fin64 = fin.astype(f64)
            h_ms, _ = time_call(lambda: hamiltonian(sys64, fin64), 5)
            max_drift_f = float(drift.max())
            rate = BATCH * n_steps / el
            fam_runs[run_label] = dict(rate=rate, drift=max_drift_f, launches=counts,
                                       seconds=el, sample_ms=h_ms, samples=samples,
                                       steps=n_steps, dt=dt)
            log(f"phase 15: {run_label} {BATCH} x n={system.n} {str(system.dtype)[6:]} (2,0) "
                f"kahan dt={dt}, {n_steps} steps (t = {FAMILY_HORIZON:g}) in {el:.3f} s: "
                f"{rate:.6e} member-steps/s, max|dH/H0| {max_drift_f:.6e}, launches "
                f"{ {k: v for k, v in counts.items() if v} }, float64 drift sample "
                f"{h_ms:.3f} ms x {1 + samples}")
            gated = label in ("spherical", "spring") or run_label == "twobody float64"
            if gated and not max_drift_f < DRIFT_BOUND:
                raise AssertionError(f"{run_label} drift {max_drift_f:.3e} >= {DRIFT_BOUND}")
        summary[f"{label}_fused_member_steps_per_sec"] = fam_runs[label]["rate"]
        summary[f"{label}_fused_max_drift"] = fam_runs[label]["drift"]
        summary[f"{label}_dt"] = dt
    summary["twobody_float64_fused_max_drift"] = fam_runs["twobody float64"]["drift"]
    summary["twobody_float64_fused_member_steps_per_sec"] = fam_runs["twobody float64"]["rate"]

    # (d) the fused rate against the library leapfrog's, cut to 200 steps
    rng_d = np.random.default_rng(11)
    for label, make, scale, dt in fam_cases[:2]:
        ex32 = make(device=dev, dtype=f32)
        ph_d = family_phase(make(device=dev, dtype=f64), BATCH, scale, rng_d, dev)
        run = lambda: evolve_ensemble_final(  # noqa: E731
            ex32.system, ph_d, dt, FAMILY_LIBRARY_STEPS, method="leapfrog", iters=(2, 0),
            compensated=True, track_drift=False, drift_every=FAMILY_LIBRARY_STEPS)
        run()  # warm-up
        t0 = time.perf_counter()
        (lib_fin, _), counts = counted(run)
        el = time.perf_counter() - t0
        expect_counts(f"{label} library leapfrog", counts)  # n = 2: closed-form solves
        if not all_finite(lib_fin.q, lib_fin.p):
            raise AssertionError(f"{label} library leapfrog output is not finite")
        lib_rate = BATCH * FAMILY_LIBRARY_STEPS / el
        ratio = fam_runs[label]["rate"] / lib_rate
        log(f"phase 15: {label} library leapfrog f32 (2,0) kahan, {FAMILY_LIBRARY_STEPS} "
            f"steps in {el:.3f} s: {lib_rate:.6e} member-steps/s; fused / library "
            f"{ratio:.2f}")
        summary[f"{label}_library_member_steps_per_sec"] = lib_rate
        summary[f"{label}_fused_vs_library"] = ratio

    # (e) each family's K1 row: a 50-step launch at 16384 members
    rng_e = np.random.default_rng(16)
    for label, make, scale, dt in fam_cases:
        ex32 = make(device=dev, dtype=f32)
        forms = ex32.system.fused_forms(ex32.system)
        st = fused_stepper(forms, iters=(2, 0), compensated=True, steps_per_call=FAMILY_SPC)
        state = st.init(family_phase(make(device=dev, dtype=f64), BATCH, scale, rng_e, dev))
        coef = coef_table(forms, dev, f32)
        kw = dict(iters=(2, 0), compensated=True, steps_per_call=FAMILY_SPC)

        def kern():
            return fused_step_kernel(forms, state, dt, coef=coef, **kw)

        def plain():
            return fused_step_reference(forms, state, dt, **kw)

        k_out = kern()
        p1, p_out = time_call(plain, 1)
        k1, h1 = time_queued(kern, 100)
        k2, h2 = time_queued(kern, 100)
        p2, _ = time_call(plain, 1)
        worst, errs, failures = compare_states(k_out, p_out, "float32")
        if failures:
            raise AssertionError(f"{label}: 50-step family kernel disagrees with its plain "
                                 f"version: " + "; ".join(failures))
        bound_ms, bound_by, cost = k1_bound(ex32.system, "leapfrog_fused", (2, 0), True,
                                            BATCH, FAMILY_SPC)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        run = fam_runs[label]
        k1_share = ms * run["launches"]["family_step"] / 1e3 / run["seconds"]
        sample_share = run["sample_ms"] * (1 + run["samples"]) / 1e3 / run["seconds"]
        log(f"phase 15: family_step {label} n={forms.n} f32 (2,0) kahan B={BATCH} "
            f"spc={FAMILY_SPC}: kernel {ms:.4f} ms on the card ({k1:.4f}, {k2:.4f}), host "
            f"{(h1 + h2) / 2 * 1e3:.2f} us to issue one ({h1 * 1e3:.2f}, {h2 * 1e3:.2f}), "
            f"plain {plain_ms:.2f} ms ({p1:.2f}, {p2:.2f}), bound {bound_ms:.6f} ms "
            f"({bound_by}; {cost['flops_per_member_step']:.2f} flops, "
            f"{cost['transcendentals_per_member_step']:.2f} transcendentals a member-step); "
            f"of the t = {FAMILY_HORIZON:g} run's {run['seconds']:.3f} s: K1 {k1_share:.3f} "
            f"({run['launches']['family_step']} launches), drift samples {sample_share:.3f}; "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        entries.append({
            "name": f"family_step {forms.name}"
                    f"{' 2 points' if label == 'bezier2' else ''} n={forms.n} float32 kahan "
                    f"(2,0)",
            "route": "cuda", "source": FAMILY_SOURCE, "replaces": REPLACES,
            "launches": run["launches"]["family_step"],
            "max_abs_err": max(worst, fam_err[label]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        summary[f"{label}_k1_ms"] = ms
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")


def k1_row(name, source, forms, state, dt, kw, system, method, launches, extra_err=0.0):
    """A K1 row at one launch's shape: the kernel against its plain version
    (in turns on one card: plain, kernel, kernel, plain), its queued device
    ms, the host's issue and the bound; raises if they disagree."""
    from hamilton_tpu_torch.ops.fused_step import fused_step_kernel, fused_step_reference
    from hamilton_tpu_torch.utils.profiling import time_queued

    def kern():
        return fused_step_kernel(forms, state, dt, **kw)

    def plain():
        return fused_step_reference(forms, state, dt, **kw)

    k_out = kern()
    p1, p_out = time_call(plain, 1)
    k1, h1 = time_queued(kern, 100)
    k2, h2 = time_queued(kern, 100)
    p2, _ = time_call(plain, 1)
    dname = str(state.dtype).split(".")[-1]
    worst, errs, failures = compare_states(k_out, p_out, dname)
    if failures:
        raise AssertionError(f"{name}: kernel disagrees with its plain version: "
                             + "; ".join(failures))
    batch, spc = state.shape[2], kw["steps_per_call"]
    bound_ms, bound_by, cost = k1_bound(system, method, kw["iters"], kw["compensated"], batch,
                                        spc)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    log(f"{name} B={batch} spc={spc}: kernel {ms:.4f} ms on the card ({k1:.4f}, {k2:.4f}), "
        f"host {(h1 + h2) / 2 * 1e3:.2f} us to issue one ({h1 * 1e3:.2f}, {h2 * 1e3:.2f}), "
        f"plain {plain_ms:.2f} ms ({p1:.2f}, {p2:.2f}), bound {bound_ms:.6f} ms ({bound_by}; "
        f"{cost['flops_per_member_step']:.2f} flops, "
        f"{cost['transcendentals_per_member_step']:.2f} transcendentals a member-step), "
        f"launches {launches}; " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return {
        "name": name, "route": "cuda", "source": source, "replaces": REPLACES,
        "launches": launches, "max_abs_err": max(worst, extra_err), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def phase_chain_solvers(dev, ph, head_rate, regs, entries, summary):
    """Phase 16: the chain's Möbius and L⁻¹ forms on K1's chain-variant
    kernel (``csrc/chain_variants.cu``), at the headline's configuration;
    ``regs`` is its ptxas report (:func:`ptxas_report`); appends each one's
    rows to ``entries`` and its readings to ``summary``."""
    import numpy as np
    import torch
    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.convert import params_from_numpy
    from hamilton_tpu_torch.ensemble import evolve_ensemble_chunked
    from hamilton_tpu_torch.integrators.fixed import make_stepper
    from hamilton_tpu_torch.models import chain
    from hamilton_tpu_torch.ops.fused_step import (
        SUZUKI4_COMPOSITION, coef_table, fused_step_kernel, fused_step_reference,
        fused_stepper,
    )
    from hamilton_tpu_torch.state import Phase

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    spc, chunk = 50, 10_000
    # phase 13's per-member tables
    rng = np.random.default_rng(7)
    sweep_np = {"masses": 1.0 + 0.05 * rng.standard_normal((BATCH, 20))}
    sweep_np["lengths"] = np.ones((BATCH, 20))
    sweep_np["gravity"] = 5.0 + 0.1 * rng.standard_normal(BATCH)

    def one_launch(solver, dtype, iters, comp):
        ex = chain(n_links=20, fused_solver=solver, device=dev, dtype=dtype)
        st = fused_stepper(ex.system.fused_forms(ex.system), iters=iters, compensated=comp,
                           steps_per_call=spc)
        return st.extract(st.step(st.init(ph.astype(dtype)), 5e-4))

    semisep = {dtype: one_launch("semiseparable", dtype, iters, comp)
               for dtype, iters, comp in ((f64, (3, 2), False), (f32, (2, 0), True))}
    ex5 = chain(n_links=5, device=dev, dtype=f64)
    ph5 = jittered_phase(ex5, 1000, f64, dev, 2)
    ph5 = Phase(ph5.q, ph5.p + 0.01)
    ph20 = Phase(ph.q[:1000].to(f64), ph.p[:1000].to(f64) + 0.01)
    dt_lib = torch.tensor(1e-3, dtype=f64)
    for solver in CHAIN_SOLVERS:
        def make(dtype, n=20):
            return chain(n_links=n, fused_solver=solver, device=dev, dtype=dtype)

        # (a) the kernel against its plain version: float32 (2,0) Kahan and
        # float64 (3,2), shared and per-member tables, and composed
        checks = []
        for dtype, iters, comp in ((f32, (2, 0), True), (f64, (3, 2), False)):
            system = make(dtype).system
            swept = system.replace_params(params_from_numpy(sweep_np, device=dev, dtype=dtype))
            tag = f"{str(dtype)[6:]} {iters}{' kahan' if comp else ''}"
            checks.append((tag, system, iters, comp, (1.0,)))
            checks.append((f"{tag} per-member", swept, iters, comp, (1.0,)))
        checks.append(("float32 (2, 0) kahan suzuki4", make(f32).system, (2, 0), True,
                       SUZUKI4_COMPOSITION))
        failures, worst_a = [], 0.0
        for label, system, iters, comp, composition in checks:
            forms = system.fused_forms(system)
            st = fused_stepper(forms, iters=iters, compensated=comp, composition=composition)
            carry = st.init(ph.astype(system.dtype))
            state, table = carry if forms.consts is None else (carry, None)
            kw = dict(iters=iters, compensated=comp, steps_per_call=5,
                      composition=composition, coef=table)
            k_out = fused_step_kernel(forms, state, 5e-4, **kw)
            p_out = fused_step_reference(forms, state, 5e-4, **kw)
            torch.cuda.synchronize()
            dname = str(system.dtype)[6:]
            worst, errs, fails = compare_states(k_out, p_out, dname)
            if not torch.equal(k_out, p_out):
                fails.append("not equal bit for bit")
            failures += [f"{label}: {f}" for f in fails]
            if dname == "float32":
                worst_a = max(worst_a, worst)
            log(f"phase 16 {'FAILED' if fails else 'ok'}: {solver} {label} kernel vs plain, "
                f"B={BATCH} spc=5: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        # ragged batches, float32 (2,0) Kahan shared and float64 (3,2)
        # per-member tables
        for batch in RAGGED_BATCHES:
            sub = Phase(ph.q[:batch], ph.p[:batch])
            for dtype, iters, comp, swept in ((f32, (2, 0), True, False),
                                              (f64, (3, 2), False, True)):
                system = make(dtype).system
                if swept:
                    system = system.replace_params(params_from_numpy(
                        {k: v[:batch] for k, v in sweep_np.items()}, device=dev, dtype=dtype))
                forms = system.fused_forms(system)
                carry = fused_stepper(forms, iters=iters, compensated=comp).init(
                    sub.astype(dtype))
                state, table = carry if swept else (carry, None)
                kw = dict(iters=iters, compensated=comp, steps_per_call=5, coef=table)
                k_out = fused_step_kernel(forms, state, 5e-4, **kw)
                p_out = fused_step_reference(forms, state, 5e-4, **kw)
                torch.cuda.synchronize()
                label = f"B={batch} {str(dtype)[6:]} {iters}{' per-member' if swept else ''}"
                equal = torch.equal(k_out, p_out)
                if not equal:
                    failures.append(f"{label}: not equal bit for bit "
                                    f"({float((k_out - p_out).abs().max()):.3e})")
                log(f"phase 16 {'ok' if equal else 'FAILED'}: {solver} {label} kernel vs "
                    f"plain, spc=5: {'equal' if equal else 'differ'}")
        if failures:
            raise AssertionError(f"{solver} kernel disagrees with its plain version: "
                                 + "; ".join(failures))

        # (b) against the semiseparable kernel over one 50-step launch
        for dtype, iters, comp in ((f64, (3, 2), False), (f32, (2, 0), True)):
            out = one_launch(solver, dtype, iters, comp)
            ref = semisep[dtype]
            err = max(float((out.q - ref.q).abs().max()), float((out.p - ref.p).abs().max()))
            limit = FORMS_TOL[str(dtype)[6:]]
            log(f"phase 16 {'ok' if err <= limit else 'FAILED'}: {solver} vs semiseparable "
                f"kernel, {str(dtype)[6:]} {iters}, {BATCH} x chain-20, one {spc}-step "
                f"launch: {err:.3e} (limit {limit:.0e})")
            if not (all_finite(out.q, out.p) and err <= limit):
                raise AssertionError(f"{solver} vs semiseparable: {err:.3e} > {limit:.0e}")
            summary[f"{solver}_vs_semiseparable_{str(dtype)[6:]}"] = err

        # (c) float64 (3,2) against the library leapfrog: chain-20 and chain-5
        n5_launches = 0
        for n, ph_c in ((20, ph20), (5, ph5)):
            system = make(f64, n).system
            lib = make_stepper(system, "leapfrog", iters=(3, 2))
            fus = make_stepper(system, "leapfrog_fused", iters=(3, 2))
            c_lib, c_fus = lib.init(ph_c), fus.init(ph_c)
            for _ in range(2):
                c_lib = lib.step(c_lib, dt_lib)
            c_fus, counts = counted(lambda: fus.step(fus.step(c_fus, dt_lib), dt_lib))
            expect_counts(f"{solver} chain-{n} fused", counts, chain_variants=2)
            a, b = lib.extract(c_lib), fus.extract(c_fus)
            err = max(float((a.q - b.q).abs().max()), float((a.p - b.p).abs().max()))
            log(f"phase 16 {'ok' if err <= PHYSICS_TOL else 'FAILED'}: {solver} chain-{n} "
                f"float64 (3,2) kernel vs library leapfrog, 1000 members, 2 steps: {err:.2e}")
            if not err <= PHYSICS_TOL:
                raise AssertionError(f"{solver} chain-{n} vs library leapfrog {err:.3e}")
            if n == 5:
                n5_launches = counts["chain_variants"]

        # (d) the headline run on this form: 2e5 steps, exactly 4000 launches
        ex32 = make(f32)
        marks = []
        t0 = time.perf_counter()
        (fin, drift), counts = counted(lambda: evolve_ensemble_chunked(
            ex32.system, ph, 5e-4, HEADLINE_STEPS, chunk_steps=chunk, method="leapfrog_fused",
            iters=(2, 0), compensated=True, drift_every=1000, drift_dtype=f64,
            callback=lambda ci, phase, d: marks.append(time.perf_counter()),
            steps_per_call=spc))
        expect_counts(f"{solver} headline", counts, chain_variants=HEADLINE_STEPS // spc,
                      spd_solve=1 + HEADLINE_STEPS // 1000)
        if not all_finite(fin.q, fin.p, drift) or tuple(fin.q.shape) != (BATCH, 20):
            raise AssertionError(f"{solver} headline output is not finite or not (16384, 20)")
        rate, first, n_chunks = steady_rate(marks, t0, BATCH, chunk)
        max_drift = float(drift.max())
        log(f"phase 16: {solver} 16384 x chain-20 float32 (2,0) kahan dt=5e-4, "
            f"{HEADLINE_STEPS} steps: {rate:.6e} member-steps/s over {n_chunks} steady chunks "
            f"(first chunk {first:.3f} s; {rate / head_rate:.4f} of the headline), "
            f"max|dH/H0| {max_drift:.6e}, launches {counts}")
        if not max_drift < DRIFT_BOUND:
            raise AssertionError(f"{solver} headline drift {max_drift:.3e} >= {DRIFT_BOUND}")
        summary[f"{solver}_member_steps_per_sec"] = rate
        summary[f"{solver}_max_drift"] = max_drift

        # (e) the K1 rows: the 50-step launch at 16384 members, n = 20 and 5
        for n, launches in ((20, counts["chain_variants"]), (5, n5_launches)):
            exn = make(f32, n)
            forms = exn.system.fused_forms(exn.system)
            st = fused_stepper(forms, iters=(2, 0), compensated=True, steps_per_call=spc)
            phn = ph if n == 20 else jittered_phase(exn, BATCH, f32, dev, 16)
            kw = dict(iters=(2, 0), compensated=True, steps_per_call=spc,
                      coef=coef_table(forms, dev, f32))
            row = k1_row(f"chain_variants {forms.name} n={n} float32 kahan (2,0)",
                         CHAIN_SOURCE, forms, st.init(phn), 5e-4, kw, exn.system,
                         "leapfrog_fused", launches, worst_a if n == 20 else 0.0)
            log(f"phase 16: {row['name']}: {row['ms']:.4f} ms a launch")
            entries.append(row)
            summary[f"{solver}_n{n}_k1_ms"] = row["ms"]
            # its layout as built, registers and spills
            lanes, block, smem, blocks = kernels.lane_layout(
                "chain_variants", 0, CHAIN_CODES.index(f"{solver} n={n}"))
            by_name = {name: (r, st, ld) for name, r, st, ld in regs}
            r, st, ld = by_name[f"float {solver} n={n} kahan"]
            plural = "s" if lanes > 1 else ""
            log(f"phase 16: {solver} n={n} float32 kahan: {lanes} lane{plural} a member, {block} "
                f"threads and {smem} B of shared memory a block, {blocks} blocks "
                f"({blocks * block // 32} warps) an SM, {r} registers, spill stores "
                f"{st} B, spill loads {ld} B")
            summary[f"{solver}_n{n}_lanes"] = lanes
            summary[f"{solver}_n{n}_shared_bytes"] = smem
            summary[f"{solver}_n{n}_warps_per_sm"] = blocks * block // 32
            summary[f"{solver}_n{n}_registers"] = r
            summary[f"{solver}_n{n}_spills"] = [st, ld]
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")


def k2_plain_grad_fn(entry):
    """The entry's function in differentiable plain PyTorch: the out-of-place
    masked Cholesky (``batched_spd.masked_cholesky``) and two triangular
    solves."""
    import torch
    from hamilton_tpu_torch.ops.batched_spd import masked_cholesky

    def solve(low, b):
        y = torch.linalg.solve_triangular(low, b[..., None], upper=False)
        return torch.linalg.solve_triangular(low.mT, y, upper=True)[..., 0]

    return {
        "spd_solve_batched": lambda k, b: solve(masked_cholesky(k), b),
        "cholesky_batched": masked_cholesky,
        "cho_solve_batched": solve,
        "spd_solve_jac": lambda js, b: solve(masked_cholesky(js.mT @ js), b),
        "cholesky_jac": lambda js: masked_cholesky(js.mT @ js),
    }[entry.name]


def phase_gradients(dev, ph, entries, summary):
    """Phase 17: gradients at full width — the K2 entries' backwards, the
    fused step's replay against the library leapfrog and a central
    difference, the replay's cost, and ``fit_masses --fused``."""
    import contextlib
    import io

    import torch
    from hamilton_tpu_torch.examples import fit_masses
    from hamilton_tpu_torch.integrators.fixed import make_stepper
    from hamilton_tpu_torch.models import chain
    from hamilton_tpu_torch.ops.batched_spd import ENTRIES
    from hamilton_tpu_torch.ops.fused_step import coef_table, fused_stepper
    from hamilton_tpu_torch.state import Phase

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64

    # (a) each K2 entry's gradient at n = 20 by its kernel against autograd
    # through the plain masked Cholesky and triangular solves, on the same
    # card tensors; a solve's backward launches its kernel once more
    for dtype in (f32, f64):
        dname = str(dtype)[6:]
        k, js, b = k2_inputs(BATCH, 20, dtype, dev, 17)
        g = torch.Generator(device=dev).manual_seed(17)
        row = []
        for e in ENTRIES:
            args = [a.detach().requires_grad_(True) for a in k2_args(e, k, js, b)]
            out = e.entry(*args)
            cot = torch.randn(out.shape, device=dev, dtype=dtype, generator=g)
            got, counts = counted(lambda: torch.autograd.grad(out, args, cot))
            expect_counts(f"{e.name} backward {dname}", counts,
                          **({_launch_name(e): 1} if e.solves else {}))
            want = torch.autograd.grad(k2_plain_grad_fn(e)(*args), args, cot)
            if e.name == "spd_solve_batched":
                # the plain factorization reads K's lower triangle: the
                # kernel's full gK acts on a symmetric K as tril(gK + gKᵀ)
                # less its diagonal
                gk = got[0]
                got = (torch.tril(gk + gk.mT) - torch.diag_embed(torch.diagonal(gk, 0, -2, -1)),
                       got[1])
            err = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                      for x, y in zip(got, want))
            limit = K2_GRAD_TOL[dname]
            row.append(f"{e.name} {err:.2e}")
            if not (all_finite(*got) and err <= limit):
                raise AssertionError(f"{e.name} {dname}: kernel gradient vs plain autograd "
                                     f"{err:.3e} > {limit:.0e}")
            summary[f"{e.name}_grad_err_{dname}"] = err
        log(f"phase 17 ok: K2 gradients, {BATCH} x n=20 {dname}, kernel vs autograd through "
            f"the plain version (relative; a solve's backward launched its kernel once): "
            + ", ".join(row))
    del k, js, b

    # (b) float64 (3,2): the gradient of a final-state loss with respect to
    # (q₀, p₀) and the 20 shared masses through one GRAD_STEPS-step fused
    # launch, against as many library-leapfrog steps (their backward on K2)
    # and a central difference on one mass
    ex = chain(n_links=20, fused_solver="semiseparable", device=dev, dtype=f64)
    ph64 = ph.astype(f64)
    m0 = ex.system.params["masses"].detach().clone()
    dt = 5e-4

    def loss_of(method, masses, q0, p0):
        system = ex.system.replace_params(dict(ex.system.params, masses=masses))
        fused = method == "leapfrog_fused"
        st = make_stepper(system, method, iters=(3, 2),
                          steps_per_call=GRAD_STEPS if fused else 1)
        carry = st.init(Phase(q0, p0))
        step_dt = dt if fused else torch.tensor(dt, dtype=f64)
        for _ in range(1 if fused else GRAD_STEPS):
            carry = st.step(carry, step_dt)
        out = st.extract(carry)
        return torch.sum(out.q ** 2) + torch.sum(out.p * out.q)

    grads, secs, fwd_counts, bwd_counts = {}, {}, {}, {}
    for method in ("leapfrog_fused", "leapfrog"):
        leaves = [t.detach().clone().requires_grad_(True) for t in (ph64.q, ph64.p, m0)]
        t0 = time.perf_counter()
        loss, fwd_counts[method] = counted(lambda: loss_of(method, leaves[2], *leaves[:2]))
        grads[method], bwd_counts[method] = counted(
            lambda: torch.autograd.grad(loss, leaves))
        secs[method] = time.perf_counter() - t0
        del loss
    expect_counts("fused gradient forward", fwd_counts["leapfrog_fused"], fused_step=1)
    expect_counts("fused gradient backward", bwd_counts["leapfrog_fused"])
    if not bwd_counts["leapfrog"]["cho_solve"]:
        raise AssertionError("the library leapfrog's backward launched no K2c")
    rel = [float((a - b).abs().max()) / float(b.abs().max())
           for a, b in zip(grads["leapfrog_fused"], grads["leapfrog"])]
    eps = 1e-5
    e1 = torch.zeros_like(m0)
    e1[7] = eps
    with torch.no_grad():
        fd = (loss_of("leapfrog_fused", m0 + e1, ph64.q, ph64.p)
              - loss_of("leapfrog_fused", m0 - e1, ph64.q, ph64.p)) / (2 * eps)
    g7 = float(grads["leapfrog_fused"][2][7])
    fd_rel = abs(g7 - float(fd)) / abs(float(fd))
    log(f"phase 17: float64 (3,2) gradient, {BATCH} x chain-20, {GRAD_STEPS} steps: fused (one "
        f"launch, the replay backward) vs library leapfrog ({GRAD_STEPS} steps, backward on K2): "
        f"relative "
        f"{rel[0]:.3e} (q0), {rel[1]:.3e} (p0), {rel[2]:.3e} (masses); dL/dm7 {g7:.12e} vs "
        f"central difference {float(fd):.12e} ({fd_rel:.3e}); fused "
        f"{secs['leapfrog_fused']:.3f} s, library {secs['leapfrog']:.3f} s; library launches "
        f"forward {fwd_counts['leapfrog']}, "
        f"backward {bwd_counts['leapfrog']}")
    if not max(rel) <= GRAD_TOL or not fd_rel <= FD_RTOL:
        raise AssertionError(f"fused gradient vs library leapfrog {max(rel):.3e} (limit "
                             f"{GRAD_TOL}) or vs central difference {fd_rel:.3e} (limit {FD_RTOL})")
    summary.update({"fused_grad_vs_library": max(rel), "fused_grad_vs_fd": fd_rel})
    del grads

    # (c) float32 (2,0) Kahan: the forward (the kernel) and the backward (the
    # replay) of one 50-step launch, and the peak memory
    ex32 = chain(n_links=20, fused_solver="semiseparable", device=dev, dtype=f32)
    masses = ex32.system.params["masses"].detach().clone().requires_grad_(True)
    system = ex32.system.replace_params(dict(ex32.system.params, masses=masses))
    st = make_stepper(system, "leapfrog_fused", iters=(2, 0), compensated=True,
                      steps_per_call=50)
    q0 = ph.q.detach().clone().requires_grad_(True)
    st.step(st.init(Phase(ph.q, ph.p)), 5e-4)  # warm-up, no gradient
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = st.extract(st.step(st.init(Phase(q0, ph.p)), 5e-4))
    loss = torch.sum(out.q ** 2)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (gq, gm), counts = counted(lambda: torch.autograd.grad(loss, (q0, masses)))
    bwd_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    expect_counts("replay backward", counts)
    if not all_finite(gq, gm):
        raise AssertionError("the replay's gradient is not finite")
    del out, loss, gq, gm
    log(f"phase 17: float32 (2,0) kahan gradient, {BATCH} x chain-20, one 50-step launch, "
        f"(q0, masses): forward {fwd_s * 1e3:.1f} ms (the kernel, with the table and the "
        f"carry built), backward (the replay) {bwd_s * 1e3:.1f} ms, peak memory above the "
        f"inputs {peak / 2**30:.3f} GiB")
    summary.update({"replay_forward_ms": fwd_s * 1e3, "replay_backward_ms": bwd_s * 1e3,
                    "replay_peak_bytes": peak})

    # (d) fit_masses --fused on the card, cut to FIT_ITERS iterations
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc, counts = counted(lambda: fit_masses.main(
            ["--fused", "--device", "cuda", "--iters", str(FIT_ITERS)]))
    el = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.strip().splitlines():
        log(f"phase 17: fit_masses | {line}")
    expect_counts("fit_masses --fused", counts, chain_variants=FIT_ITERS + 1)
    first, last = (float(x) for x in re.search(r"loss (\S+) -> (\S+)", text).groups())
    log(f"phase 17 {'ok' if last <= first / 10 else 'FAILED'}: fit_masses --fused, "
        f"{FIT_ITERS} iterations in {el:.1f} s: loss {first:.3e} -> {last:.3e} "
        f"({first / last:.1f}x), masses within 0.05: {rc == 0}")
    if not last <= first / 10:
        raise AssertionError(f"fit_masses --fused: the loss fell only {first / last:.2f}x")
    summary.update({"fit_masses_loss_fall": first / last, "fit_masses_seconds": el,
                    "fit_masses_recovered": rc == 0})

    # the dense n = 4 row: one launch at the example's shape
    ex4 = chain(n_links=4, device=dev, dtype=f32)
    forms = ex4.system.fused_forms(ex4.system)
    st4 = fused_stepper(forms, iters=(3, 1), compensated=False, steps_per_call=24)
    ph4 = Phase(ex4.init_phase.q.expand(1024, 4).contiguous(),
                torch.tensor([0.8, -0.3, 0.5, -0.2], device=dev).expand(1024, 4).contiguous())
    kw = dict(iters=(3, 1), compensated=False, steps_per_call=24,
              coef=coef_table(forms, dev, f32))
    row = k1_row("chain_variants serial_chain n=4 float32 (3,1) (fit_masses --fused)",
                 CHAIN_SOURCE, forms, st4.init(ph4), 0.01, kw, ex4.system, "leapfrog_fused",
                 counts["chain_variants"])
    entries.append(row)
    summary["dense4_k1_ms"] = row["ms"]
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")


def user_family_headers(dev):
    """The generated headers phase 18 runs, by label: the elastic pendulum
    and the 3-point Bézier (one header serves every parameter value)."""
    import torch
    from hamilton_tpu_torch.examples import elastic_pendulum
    from hamilton_tpu_torch.models import bezier
    from hamilton_tpu_torch.ops import fused_codegen

    systems = {"elastic_pendulum": elastic_pendulum.make_system(device=dev,
                                                                dtype=torch.float32),
               "bezier 3 points": bezier(BEZIER3_POINTS, device=dev,
                                         dtype=torch.float32).system}
    return {label: fused_codegen.generated(system.fused_forms(system)).header
            for label, system in systems.items()}


def phase_user_family(dev, user_builds, entries, summary):
    """Phase 18: a user's own family (and a bundled one at a size not
    compiled) on K1's generated kernel; appends each one's row to
    ``entries`` and its readings to ``summary``."""
    import contextlib
    import io

    import numpy as np
    import torch
    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.convert import phase_from_numpy
    from hamilton_tpu_torch.ensemble import evolve_ensemble_final
    from hamilton_tpu_torch.examples import elastic_pendulum
    from hamilton_tpu_torch.integrators.fixed import make_stepper
    from hamilton_tpu_torch.models import bezier
    from hamilton_tpu_torch.ops import fused_codegen
    from hamilton_tpu_torch.ops.fused_step import (
        KERNEL_INSTANTIATIONS, SUZUKI4_COMPOSITION, _kernel_key, fused_step_kernel,
        fused_step_reference, fused_stepper,
    )
    from hamilton_tpu_torch.state import Phase

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    for label, (key, build) in user_builds.items():
        regs = ptxas_report(build.log, _USER_RE, _user_label)
        if not regs:
            raise AssertionError(f"nvcc printed no -Xptxas -v report for {label}")
        log(f"phase 18: build of the generated kernel for {label}: {build.seconds:.1f} s "
            f"(library {key}), {len(regs)} instantiations")
        for kname, nreg, st, ld in regs:
            log(f"ptxas: user_family {label}: {kname:<45} {nreg:3d} registers, spill "
                f"stores {st} B, spill loads {ld} B")
        summary[f"user_family_build_s {label}"] = build.seconds

    # (a) the generated kernel against its plain version, bit for bit
    def elastic(dtype):
        return elastic_pendulum.make_system(device=dev, dtype=dtype)

    def bezier3(dtype):
        return bezier(BEZIER3_POINTS, device=dev, dtype=dtype).system

    cases = (("elastic_pendulum", elastic, (0.3, 1.1)), ("bezier 3 points", bezier3, (0.5,)))
    rng = np.random.default_rng(18)
    checks = 0
    for label, make, centre in cases:
        for dtype in (f32, f64):
            system = make(dtype)
            modes = {
                USER_TABLES[0]: system,
                USER_TABLES[1]: system.replace_params(
                    {k: v.clone().requires_grad_(True) for k, v in system.params.items()}),
                USER_TABLES[2]: system.replace_params({
                    k: v.expand(BATCH, *v.shape) * torch.as_tensor(
                        1.0 + 0.01 * rng.standard_normal((BATCH,) + (1,) * v.ndim),
                        device=dev, dtype=dtype)
                    for k, v in system.params.items()}),
            }
            n = len(centre)
            q = np.asarray(centre) + 0.01 * rng.standard_normal((BATCH, n))
            p = 0.05 * rng.standard_normal((BATCH, n))
            ph = phase_from_numpy(q, p, device=dev, dtype=dtype)
            for mode, sysm in modes.items():
                forms = sysm.fused_forms(sysm)
                if _kernel_key(forms) in KERNEL_INSTANTIATIONS:
                    raise AssertionError(f"{label} has a hand-written instantiation")
                for comp in (False, True):
                    for composition in ((1.0,), SUZUKI4_COMPOSITION):
                        st = fused_stepper(forms, iters=(2, 1), compensated=comp,
                                           composition=composition)
                        carry = st.init(ph)
                        state, table = carry if forms.consts is None else (carry, None)
                        state = state.detach()
                        table = None if table is None else table.detach()
                        kw = dict(iters=(2, 1), compensated=comp, steps_per_call=5,
                                  composition=composition, coef=table)
                        got, counts = counted(lambda: fused_step_kernel(forms, state, 1e-3,
                                                                        **kw))
                        expect_counts(f"{label} {mode}", counts, user_family=1)
                        with torch.no_grad():
                            want = fused_step_reference(forms, state, 1e-3, **kw)
                        torch.cuda.synchronize()
                        err = float((got.double() - want.double()).abs().max())
                        same = torch.equal(got, want) and all_finite(got)
                        checks += 1
                        if not same:
                            raise AssertionError(
                                f"{label} {str(dtype)[6:]} {mode}{' kahan' if comp else ''}"
                                f"{' composed' if len(composition) > 1 else ''}: generated "
                                f"kernel differs from its plain version by {err:.3e}")
            log(f"phase 18 ok: {label} {str(dtype)[6:]} generated kernel vs plain, {BATCH} "
                f"members, 5 steps: equal bit for bit in all 12 modes (3 tables x "
                f"compensated or not x plain or composed)")
    for dtype in (f32, f64):
        x = torch.as_tensor(rng.standard_normal(1 << 20), device=dev, dtype=dtype)
        for c in (0.3, 7.0):
            recip = x * (torch.tensor(1.0, device=dev, dtype=dtype)
                         / torch.tensor(c, device=dev, dtype=dtype))
            full = x / torch.full_like(x, c)
            if not torch.equal(x / c, recip):
                raise AssertionError(f"x / {c} on the card is not x * (1/T({c})) in "
                                     f"{dtype}: the generated code's rounding assumes it is")
            log(f"phase 18 ok: {str(dtype)[6:]} x / {c} on the card equals x * (T(1)/T({c})) "
                f"bit for bit; it differs from x / full_like(x, {c}) in "
                f"{int((x / c != full).sum())} of {x.numel()} elements")
    summary["user_family_bitwise_checks"] = checks

    # (b) the float64 kernel against the library leapfrog
    sys64 = elastic_pendulum.make_system(spring_k=3.0 * 9.8, device=dev, dtype=f64)
    rng_b = np.random.default_rng(0)
    qb = np.stack([0.3 + 0.02 * rng_b.standard_normal(1024),
                   1.0 + 0.1 * rng_b.standard_normal(1024)], axis=-1)
    ph_b = phase_from_numpy(qb, 0.05 * rng_b.standard_normal((1024, 2)), device=dev,
                            dtype=f64)
    lib = make_stepper(sys64, "leapfrog", iters=(3, 2))
    fus = make_stepper(sys64, "leapfrog_fused", iters=(3, 2))
    dt_b = torch.tensor(1e-3, dtype=f64)

    def two_steps():
        c_lib, c_fus = lib.init(ph_b), fus.init(ph_b)
        for _ in range(2):
            c_lib, c_fus = lib.step(c_lib, dt_b), fus.step(c_fus, dt_b)
        return lib.extract(c_lib), fus.extract(c_fus)

    (a, b), counts = counted(two_steps)
    expect_counts("elastic pendulum parity", counts, user_family=2)
    err = max(float((a.q - b.q).abs().max()), float((a.p - b.p).abs().max()))
    log(f"phase 18 {'ok' if err <= ELASTIC_PARITY_TOL else 'FAILED'}: elastic pendulum float64 "
        f"(3,2) generated kernel vs library leapfrog, 1024 members, 2 steps: {err:.2e}")
    if not err <= ELASTIC_PARITY_TOL:
        raise AssertionError(f"elastic pendulum kernel vs library leapfrog: {err:.3e}")
    summary["elastic_kernel_vs_library"] = err

    # (c) other parameter values build nothing
    runs = kernels.NVCC_RUNS["count"]
    for k, m in ((10.0, 1.0), (55.0, 0.6)):
        other = elastic_pendulum.make_system(mass=m, spring_k=k, device=dev, dtype=f32)
        forms = other.fused_forms(other)
        key, _ = kernels.build_user_family(fused_codegen.generated(forms).header)
        state = fused_stepper(forms, iters=(2, 1)).init(phase_from_numpy(
            np.full((8, 2), [0.3, 1.1]), np.zeros((8, 2)), device=dev, dtype=f32))
        fused_step_kernel(forms, state, 1e-3, iters=(2, 1), compensated=False)
        if key != user_builds["elastic_pendulum"][0] or kernels.NVCC_RUNS["count"] != runs:
            raise AssertionError(f"other parameter values rebuilt the kernel ({key}, "
                                 f"{kernels.NVCC_RUNS['count'] - runs} nvcc runs)")
    log("phase 18 ok: other parameter values (k = 10, 55; m = 1, 0.6) reuse library "
        f"{user_builds['elastic_pendulum'][0]} and launch it: no nvcc run")

    # (d) the example at 16384 members
    results = {}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc, counts = counted(lambda: elastic_pendulum.main(
            ["--fused", "--sweep", str(BATCH), "--device", "cuda"], results=results))
    el = time.perf_counter() - t0
    for line in buf.getvalue().strip().splitlines():
        log(f"phase 18: elastic_pendulum | {line}")
    expect_counts("elastic pendulum example", counts, user_family=ELASTIC_STEPS + 2)
    if rc != 0:
        raise AssertionError(f"the elastic pendulum example returned {rc}")
    if results["launches"] != {"user_family": ELASTIC_STEPS}:
        raise AssertionError(f"the sweep's launches {results['launches']}")
    log(f"phase 18 ok: elastic_pendulum --fused --sweep {BATCH}: {el:.1f} s in all, sweep "
        f"{results['seconds']:.3f} s = {results['member_steps_per_sec']:.6e} member-steps/s, "
        f"{results['launches']['user_family']} K1 launches in the sweep (+2 in the parity "
        f"stage), max|dH/H0| {results['max_drift']:.6e}, parity {results['parity_err']:.2e}, "
        f"resonance peak at k/k_res {results['peak_k_over_k_res']:.4f}")
    summary.update({"elastic_member_steps_per_sec": results["member_steps_per_sec"],
                    "elastic_sweep_seconds": results["seconds"],
                    "elastic_max_drift": results["max_drift"],
                    "elastic_peak_k_over_k_res": float(results["peak_k_over_k_res"]),
                    "elastic_launches": results["launches"]["user_family"]})

    # (e) the 3-point Bézier as a family cell
    dt_bz = 2.5e-4
    n_bz = round(FAMILY_HORIZON / dt_bz)
    bz32 = bezier3(f32)
    rng_e = np.random.default_rng(11)
    ph_bz = family_phase(bezier(BEZIER3_POINTS, device=dev, dtype=f64), BATCH, 0.05, rng_e,
                         dev)
    t0 = time.perf_counter()
    (fin, drift), counts = counted(lambda: evolve_ensemble_final(
        bz32, ph_bz, dt_bz, n_bz, method="leapfrog_fused", iters=(2, 0), compensated=True,
        drift_every=FAMILY_DRIFT_EVERY, drift_dtype=f64, steps_per_call=FAMILY_SPC))
    el_bz = time.perf_counter() - t0
    expect_counts("bezier 3 points", counts, user_family=n_bz // FAMILY_SPC)
    if not all_finite(fin.q, fin.p, drift) or tuple(fin.q.shape) != (BATCH, 1):
        raise AssertionError("bezier 3 points: output not finite or not (16384, 1)")
    bz_rate, bz_drift = BATCH * n_bz / el_bz, float(drift.max())
    log(f"phase 18: bezier 3 points {BATCH} x n=1 float32 (2,0) kahan dt={dt_bz}, {n_bz} steps "
        f"(t = {FAMILY_HORIZON:g}) in {el_bz:.3f} s: {bz_rate:.6e} member-steps/s, "
        f"max|dH/H0| {bz_drift:.6e}, launches {counts['user_family']}")
    summary.update({"bezier3_fused_member_steps_per_sec": bz_rate,
                    "bezier3_fused_max_drift": bz_drift})

    # (f) each one's launch at its run's shape
    k_res = 3.0 * 9.8
    k_grid = torch.linspace(0.35 * k_res, 2.0 * k_res, BATCH, dtype=f32, device=dev)
    sweep = elastic(f32).replace_params({
        "mass": torch.ones(BATCH, dtype=f32, device=dev),
        "gravity": torch.full((BATCH,), 9.8, dtype=f32, device=dev),
        "spring_k": k_grid, "rest_length": torch.ones(BATCH, dtype=f32, device=dev)})
    forms = sweep.fused_forms(sweep)
    st = fused_stepper(forms, iters=(2, 1))
    q0 = torch.stack([torch.full((BATCH,), 0.01, dtype=f32, device=dev),
                      1.0 + 9.8 / k_grid + 0.15], dim=-1)
    state, table = st.init(Phase(q0, torch.zeros_like(q0)))
    row = k1_row("user_family elastic_pendulum n=2 float32 (2,1) per-member tables, 1 step a "
                 "launch", USER_SOURCE, forms, state, 5e-3,
                 dict(iters=(2, 1), compensated=False, steps_per_call=1, coef=table), sweep,
                 "leapfrog_fused", results["launches"]["user_family"])
    entries.append(row)
    summary["elastic_k1_ms"] = row["ms"]
    forms_bz = bz32.fused_forms(bz32)
    st_bz = fused_stepper(forms_bz, iters=(2, 0), compensated=True, steps_per_call=FAMILY_SPC)
    row = k1_row(f"user_family bezier 3 points n=1 float32 kahan (2,0)", USER_SOURCE, forms_bz,
                 st_bz.init(ph_bz.astype(f32)), dt_bz,
                 dict(iters=(2, 0), compensated=True, steps_per_call=FAMILY_SPC), bz32,
                 "leapfrog_fused", counts["user_family"])
    entries.append(row)
    summary["bezier3_k1_ms"] = row["ms"]
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")


def fixed_step_launches(method, iters, steps):
    """The exact kernel launches of ``steps`` library fixed steps on the K
    route, derived from the steppers: one K2a a ``ham_eqs`` call.  rk4
    evaluates its four stages; the Gauss family f(y) and then, each of
    ``iters`` iterations, every stage in one folded call; tao2 its four
    flows (A, B, B, A; the ω-rotation solves nothing) and tao4 three tao2
    steps.  yoshida4 at (2,0) is three leapfrog substeps, each one factor
    (K2b) at the predictor and five substitutions (K2c): two in the p-loop,
    v0, the q-update and the end-of-step force; plus the initial factor."""
    if method == "yoshida4":
        return {"cholesky": 1 + 3 * steps, "cho_solve": 15 * steps}
    per_step = {"rk4": 4, "midpoint": 1 + iters, "gauss4": 1 + iters,
                "gauss6": 1 + iters, "tao2": 4, "tao4": 12}[method]
    return {"spd_solve": per_step * steps}


def phase_gauss4_checks(dev, summary):
    """Phase 19's checks, (a)-(c): the fixed-step default, gauss4, at full
    width, every library fixed-step method on the card against the CPU, and
    gauss4's gradient.  Run in a second process beside phase 1
    (:func:`start_gauss4_checks`); returns (a)'s K2a launches."""
    import torch
    from hamilton_tpu_torch.ensemble import evolve_ensemble, evolve_ensemble_final
    from hamilton_tpu_torch.integrators.evolve import evolve_ham_fixed
    from hamilton_tpu_torch.models import chain
    from hamilton_tpu_torch.state import Phase

    t_phase = time.perf_counter()
    f64 = torch.float64
    ex = chain(n_links=20, device=dev, dtype=f64)
    ph = jittered_phase(ex, GAUSS_BATCH, f64, dev, 0)
    # (a) exactly 1 + iters K2a launches a step (f(y) on the 1024 members,
    # then each iteration on both stages folded into 2048) and one a drift
    # sample (H(0) and every GAUSS_DRIFT_EVERY steps), and no other kernel
    samples = 1 + GAUSS_STEPS // GAUSS_DRIFT_EVERY
    want = (1 + GAUSS_ITERS) * GAUSS_STEPS + samples
    log(f"phase 19: gauss4 horizon cut to {GAUSS_STEPS} steps from the bench's "
        f"{GAUSS_BENCH_STEPS} ({samples - 1} drift samples after H(0))")
    t0 = time.perf_counter()
    (final, drift), counts = counted(lambda: evolve_ensemble_final(
        ex.system, ph, GAUSS_DT, GAUSS_STEPS, method="gauss4", iters=GAUSS_ITERS,
        drift_every=GAUSS_DRIFT_EVERY))
    el = time.perf_counter() - t0
    expect_counts("gauss4 drift run", counts, spd_solve=want)
    counts_a = counts["spd_solve"]
    if not all_finite(final.q, final.p, drift) or tuple(final.q.shape) != (GAUSS_BATCH, 20):
        raise AssertionError(f"gauss4: output not finite or shaped {tuple(final.q.shape)}")
    max_drift = float(drift.max())
    rate = GAUSS_BATCH * GAUSS_STEPS / el
    log(f"phase 19: gauss4 {GAUSS_BATCH} x chain-20 float64 iters={GAUSS_ITERS} "
        f"dt={GAUSS_DT:g}, {GAUSS_STEPS} steps in {el:.3f} s: {rate:.6e} member-steps/s, "
        f"max|dH/H0| {max_drift:.6e} (bound {GAUSS_DRIFT_BOUND:.0e}), "
        f"{counts['spd_solve']} K2a launches, in a second process beside phase 1 "
        f"({card_line()})")
    if not max_drift < GAUSS_DRIFT_BOUND:
        raise AssertionError(f"gauss4 drift {max_drift:.3e} >= {GAUSS_DRIFT_BOUND}")
    summary["gauss4_f64_member_steps_per_sec"] = rate
    summary["gauss4_f64_max_drift"] = max_drift
    summary["gauss4_f64_steps"] = GAUSS_STEPS
    summary["gauss4_f64_seconds"] = el
    # (b) every library method, card (kernels) against CPU (plain versions)
    t_part = time.perf_counter()
    log(f"phase 19: (a) took {t_part - t_phase:.1f} s")
    sl = Phase(ph.q[:GAUSS_CPU_MEMBERS], ph.p[:GAUSS_CPU_MEMBERS])
    sl_cpu = Phase(sl.q.cpu(), sl.p.cpu())
    ex_cpu = chain(n_links=20, device="cpu", dtype=f64)
    cases = [(m, ex.system, ex_cpu.system, "chain-20") for m in
             ("rk4", "midpoint", "gauss4", "gauss6", "yoshida4", "tao2", "tao4")]
    cases.append(("gauss4", generic_chain(20, dev, f64), generic_chain(20, "cpu", f64),
                  "J-route chain-20"))
    # a sweep over the masses of a hand-built system: evolve_ensemble pairs
    # the (B, m) inertia with the members, the stages stay a leading axis and
    # K2d takes (2, B) members a launch
    inert = torch.linspace(1.0, 2.0, GAUSS_CPU_MEMBERS, dtype=f64)[:, None].expand(-1, 40)
    cases.append(("gauss4", generic_chain(20, dev, f64).replace_inertia(inert),
                  generic_chain(20, "cpu", f64).replace_inertia(inert),
                  "J-route chain-20, per-member inertia, system_batched=True"))
    for method, sys_card, sys_cpu, label in cases:
        iters = (2, 0) if method == "yoshida4" else GAUSS_ITERS
        run = dict(method=method, iters=iters, emit_every=GAUSS_CPU_STEPS)
        drive = evolve_ham_fixed
        if "system_batched" in label:
            drive = functools.partial(evolve_ensemble, system_batched=True)
        card_out, counts = counted(lambda: drive(sys_card, sl, GAUSS_DT, GAUSS_CPU_STEPS, **run))
        cpu_out = drive(sys_cpu, sl_cpu, GAUSS_DT, GAUSS_CPU_STEPS, **run)
        if label.startswith("J"):
            launches = {"spd_solve_jac": (1 + GAUSS_ITERS) * GAUSS_CPU_STEPS}
        else:
            launches = fixed_step_launches(method, GAUSS_ITERS, GAUSS_CPU_STEPS)
        expect_counts(f"{method} on {label}", counts, **launches)
        err = max(float((card_out.q.cpu() - cpu_out.q).abs().max()),
                  float((card_out.p.cpu() - cpu_out.p).abs().max()))
        log(f"phase 19 {'ok' if err <= CPU_TOL_F64 else 'FAILED'}: {method} "
            f"iters={iters} on {label}, {GAUSS_CPU_MEMBERS} members x {GAUSS_CPU_STEPS} "
            f"steps float64, card vs CPU {err:.3e} (|p| up to "
            f"{float(cpu_out.p.abs().max()):.2f}), launches {launches}")
        if not (all_finite(card_out.q, card_out.p) and err <= CPU_TOL_F64):
            raise AssertionError(f"{method} on {label}: card and CPU differ by {err:.3e} "
                                 f"(limit {CPU_TOL_F64})")

    log(f"phase 19: (b) took {time.perf_counter() - t_part:.1f} s")
    t_part = time.perf_counter()

    # (c) gradients through gauss4: every K2a solve's backward launches it
    # once more (gb = K⁻¹g); remat=True runs each step's forward again in
    # the backward.  The card's gradient against the CPU's, and the peak
    # memory of the backward at full width with and without remat
    def loss_grad(system, phase, n_steps, remat):
        q = phase.q.detach().clone().requires_grad_(True)
        out = evolve_ham_fixed(system, Phase(q, phase.p), GAUSS_DT, n_steps,
                               emit_every=n_steps, iters=GAUSS_ITERS, remat=remat)
        return torch.autograd.grad((out.q[-1] ** 2).sum() + (out.p[-1] ** 2).sum(), q)[0]

    fwd = (1 + GAUSS_ITERS) * GAUSS_GRAD_STEPS
    grads = {}
    for remat in (False, True):
        g, counts = counted(lambda: loss_grad(ex.system, sl, GAUSS_GRAD_STEPS, remat))
        expect_counts(f"gauss4 gradient remat={remat}", counts,
                      spd_solve=(3 if remat else 2) * fwd)
        grads[remat] = g
    g_cpu = loss_grad(ex_cpu.system, sl_cpu, GAUSS_GRAD_STEPS, False)
    scale = float(g_cpu.abs().max())
    err = float((grads[False].cpu() - g_cpu).abs().max()) / scale
    err_remat = float((grads[True] - grads[False]).abs().max()) / scale
    log(f"phase 19: (c)'s gradients took {time.perf_counter() - t_part:.1f} s")
    peaks = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss_grad(ex.system, ph, GAUSS_GRAD_STEPS, remat)
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2**20
    log(f"phase 19 {'ok' if err <= GRAD_TOL and err_remat <= GRAD_TOL else 'FAILED'}: "
        f"gauss4 gradient of |q|^2 + |p|^2 after {GAUSS_GRAD_STEPS} steps, "
        f"{GAUSS_CPU_MEMBERS} members: card vs CPU {err:.3e}, remat vs not {err_remat:.3e} "
        f"(relative), K2a launches {2 * fwd} ({3 * fwd} with remat); at {GAUSS_BATCH} "
        f"members the backward's peak {peaks[False]:.1f} MiB ({peaks[True]:.1f} MiB with "
        f"remat)")
    if not (err <= GRAD_TOL and err_remat <= GRAD_TOL):
        raise AssertionError(f"gauss4 gradient: card vs CPU {err:.3e}, remat {err_remat:.3e}")
    summary["gauss4_grad_peak_mib"] = peaks[False]
    summary["gauss4_grad_peak_mib_remat"] = peaks[True]
    log(f"phase 19: (a)-(c) took {time.perf_counter() - t_phase:.1f} s")
    return counts_a


GAUSS_CHECKS_FLAG = "--phase-19-checks"


def start_gauss4_checks():
    """Start phase 19's checks, (a)-(c), in a second process on the same
    card.  The library path they drive is host-bound (one core of the
    machine's eight) and so is phase 1's comparison of each kernel with its
    plain version, which times nothing: the two run side by side, and
    :func:`collect_gauss4_checks` waits for the checks before phase 2.  The
    process is stopped when this one exits."""
    import atexit

    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), GAUSS_CHECKS_FLAG],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=REPO)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc


def collect_gauss4_checks(proc):
    """Wait for the checks' process: ``(its log lines, its summary)``, or
    raise with its output if it failed."""
    out, err = proc.communicate()
    lines = out.splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"phase 19's checks failed (exit {proc.returncode}):\n"
                             f"{out[-6000:]}\n{err[-6000:]}")
    return lines[:-1], json.loads(lines[-1])


def gauss4_checks_main() -> int:
    """The second process: phase 19's checks, their log, then their summary
    as one JSON line."""
    import torch

    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    summary = {}
    summary["gauss4_k2a_launches"] = phase_gauss4_checks(torch.device("cuda", 0), summary)
    phase_tools_checks(torch.device("cuda", 0), summary)
    print(json.dumps(summary), flush=True)
    return 0


def phase_gauss4(dev, entries, summary, checks):
    """Phase 19: the checks' log and summary from their process, then, on
    this one, the host's ms a gauss4 ham_eqs and K2a's time at gauss4's
    stage shape."""
    import torch
    from hamilton_tpu_torch.mechanics import _dtdq, ham_eqs
    from hamilton_tpu_torch.models import chain
    from hamilton_tpu_torch.ops.batched_spd import ENTRIES
    from hamilton_tpu_torch.state import Phase
    from hamilton_tpu_torch.utils import roofline as rl
    from hamilton_tpu_torch.utils.profiling import time_queued

    t_phase = time.perf_counter()
    lines, checked = checks
    for line in lines:
        log(line)
    summary.update(checked)
    launches = summary.pop("gauss4_k2a_launches")
    el = summary["gauss4_f64_seconds"]
    f64 = torch.float64
    ex = chain(n_links=20, device=dev, dtype=f64)
    ph = jittered_phase(ex, GAUSS_BATCH, f64, dev, 0)
    # where the host's time goes: one ham_eqs at the stages' shape, and the
    # ∂T/∂q sweep (vmap of a VJP of a JVP) inside it, host ms a call
    stages = Phase(ph.q.repeat(2, 1), ph.p.repeat(2, 1))
    host = {}
    for name, fn in (("ham_eqs", lambda: ham_eqs(ex.system, stages)),
                     ("dtdq", lambda: _dtdq(ex.system, stages.q, stages.p))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host[name] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
    log(f"phase 19: host ms a call at {2 * GAUSS_BATCH} x chain-20 float64: ham_eqs "
        f"{host['ham_eqs']:.3f} (its dT/dq sweep {host['dtdq']:.3f}); the run's wall a "
        f"ham_eqs {el / launches * 1e3:.3f} ms")
    summary["gauss4_host_ms_per_ham_eqs"] = host["ham_eqs"]

    # K2a at the stages' shape: kernel, plain version, one PyTorch call
    e = next(x for x in ENTRIES if x.name == "spd_solve_batched")
    batch = 2 * GAUSS_BATCH
    k, _, b = k2_inputs(batch, 20, f64, dev, 19)
    got, ref = e.kernel(k, b), e.plain(k, b)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not err <= K2_TOL:
        raise AssertionError(f"K2a at {batch} x 20 float64: kernel differs from its plain "
                             f"version by {err:.3e}")
    p1, _ = time_call(lambda: e.plain(k, b), 2)
    k1, _ = time_queued(lambda: e.kernel(k, b), 100)
    k2, _ = time_queued(lambda: e.kernel(k, b), 100)
    p2, _ = time_call(lambda: e.plain(k, b), 2)
    lib = lambda: torch.linalg.solve_ex(k, b, check_errors=False)[0]  # noqa: E731
    lib()
    timer = time_call if reads_back(lib) else time_queued
    l1, _ = timer(lib, 20)
    l2, _ = timer(lib, 20)
    ops, nbytes = k2_work(e, batch, 20, 0, f64)
    bound_ms, bound_by = rl.bound(ops, nbytes, f64)
    ms = (k1 + k2) / 2
    log(f"phase 19: K2a {batch} x n=20 float64 (gauss4's stages): kernel {ms:.5f} ms "
        f"({k1:.5f}, {k2:.5f}), plain {(p1 + p2) / 2:.3f} ms, one PyTorch call "
        f"{(l1 + l2) / 2:.5f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    entries.append({
        "name": f"spd_solve_batched n=20 float64 B={batch} (gauss4 stages)", "route": "cuda",
        "source": K2_SOURCE, "replaces": e.replaces, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": (l1 + l2) / 2,
    })

    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s in this process")


def phase_k2_bfloat16(dev, by_name, k2_library, f32_ms, entries):
    """Phase 7 in bfloat16: each K2 entry against its plain version, bit for
    bit, at ``K2_BATCHES`` x ``K2_BF16_SIZES`` (the J entries at m = 2n and
    m = n); the bf16 library path (a leapfrog on each route, one ham_eqs on
    each) at 16384 x chain-20, counted; and each entry timed at 16384 x 20
    (m = 40) on one operand set and on four in turn, beside its plain
    version, the float32 entry and the PyTorch call where ``torch.linalg``
    takes bf16 on the card."""
    import torch
    from hamilton_tpu_torch.ensemble import evolve_ensemble_final
    from hamilton_tpu_torch.mechanics import ham_eqs
    from hamilton_tpu_torch.models import chain
    from hamilton_tpu_torch.utils import roofline as rl
    from hamilton_tpu_torch.utils.profiling import time_queued

    t_phase = time.perf_counter()
    bf, f32 = torch.bfloat16, torch.float32
    errs = {name: 0.0 for name in by_name}
    for batch in K2_BATCHES:
        for n in K2_BF16_SIZES:
            k, js, b = k2_inputs(batch, n, bf, dev, 3000 * n + batch)
            js_n = k2_inputs(batch, n, bf, dev, 3000 * n + batch, m=n)[1]
            row = []
            for e, m in [(e, m) for e in by_name.values()
                         for m in ((2 * n, n) if e.from_jac else (0,))]:
                args = k2_args(e, k, js_n if m == n else js, b)
                got, want = e.kernel(*args), e.plain(*args)
                torch.cuda.synchronize()
                if got.dtype != bf or not all_finite(got, want):
                    raise AssertionError(f"{e.name} bfloat16 B={batch} n={n} m={m}: "
                                         f"{got.dtype}, or not finite")
                err = float((got.float() - want.float()).abs().max())
                errs[e.name] = max(errs[e.name], err)
                row.append(f"{e.name}{f' m={m}' if m else ''} {err:.1e}")
                if not (err <= K2_TOL and torch.equal(got, want)):
                    raise AssertionError(f"{e.name} bfloat16 B={batch} n={n} m={m}: kernel "
                                         f"differs from its plain version by {err:.3e}")
            log(f"phase 7 ok: bfloat16 B={batch} n={n}: " + ", ".join(row))

    # the bf16 library path a user runs: chain-20 on the K route and on the
    # J route, a leapfrog (2,0) and one ham_eqs each
    exb = chain(n_links=20, device=dev, dtype=bf)
    phb = jittered_phase(chain(n_links=20, device=dev, dtype=f32), BATCH, f32, dev, 0).astype(bf)
    gen = generic_chain(20, dev, bf)

    def bf16_path():
        outs = []
        for system in (exb.system, gen):
            final, _ = evolve_ensemble_final(system, phb, 1e-2, BF16_STEPS, method="leapfrog",
                                             iters=(2, 0), track_drift=False,
                                             drift_every=BF16_STEPS)
            outs += [final.q, final.p, *ham_eqs(system, phb)]
        return outs

    outs, counts = counted(bf16_path)
    expect_counts("bfloat16 library path", counts, cholesky=BF16_STEPS + 1,
                  cholesky_jac=BF16_STEPS + 1, cho_solve=2 * 5 * BF16_STEPS, spd_solve=1,
                  spd_solve_jac=1)
    if not all_finite(*outs) or any(t.dtype != bf for t in outs):
        raise AssertionError("bfloat16 library path: output not finite or not bfloat16")
    log(f"phase 7: bfloat16 library path, 16384 x chain-20, {BF16_STEPS} leapfrog (2,0) "
        f"steps of 1e-2 and one ham_eqs on the K route and on the J route: launches {counts}")
    launches = {"spd_solve_batched": counts["spd_solve"], "cholesky_batched": counts["cholesky"],
                "cho_solve_batched": counts["cho_solve"],
                "spd_solve_jac": counts["spd_solve_jac"], "cholesky_jac": counts["cholesky_jac"]}
    del outs

    for name, n, m in K2_BF16_ROWS:
        e = by_name[name]
        sets = [k2_args(e, *k2_inputs(BATCH, n, bf, dev, 7 + s, m=m or None))
                for s in range(K2_ROTATE)]
        args = sets[0]
        e.kernel(*args)
        e.plain(*args)  # warm-up
        p1, _ = time_call(lambda: e.plain(*args), 2)
        k1, _ = time_queued(lambda: e.kernel(*args), 100)
        k2, _ = time_queued(lambda: e.kernel(*args), 100)
        p2, _ = time_call(lambda: e.plain(*args), 2)
        turn = iter(range(10**9))
        rot, _ = time_queued(lambda: e.kernel(*sets[next(turn) % K2_ROTATE]), 100)
        lib_ms, lib_note = None, "none: bf16 unsupported" if name in k2_library else "none"
        if name in k2_library:
            lib = k2_library[name]
            try:
                lib(*args)
                torch.cuda.synchronize()
            except RuntimeError as exc:
                lib_note = f"none: bf16 unsupported ({str(exc).splitlines()[0][:80]})"
            else:
                timer = time_call if reads_back(lambda: lib(*args)) else time_queued
                l1, _ = timer(lambda: lib(*args), 20)
                l2, _ = timer(lambda: lib(*args), 20)
                lib_ms = (l1 + l2) / 2
                lib_note = f"{lib_ms:.4f} ms ({l1:.4f}, {l2:.4f})"
        ms = (k1 + k2) / 2
        ops, nbytes32 = k2_work(e, BATCH, n, m, f32)
        # the float32 member chain's operations, on bf16 bytes (half)
        bound_ms, bound_by = rl.bound(ops, nbytes32 / 2, f32)
        f32_row = f32_ms[(name, n, m)]
        log(f"phase 7: {name} 16384 x n={n}{f' m={m}' if m else ''} bfloat16: kernel "
            f"{ms:.4f} ms ({k1:.4f}, {k2:.4f}; on {K2_ROTATE} operand sets in turn "
            f"{rot:.4f}), plain {(p1 + p2) / 2:.3f} ms ({p1:.3f}, {p2:.3f}), float32 "
            f"kernel {f32_row:.4f} ms ({ms / f32_row:.3f} of it), bound {bound_ms:.5f} ms "
            f"({bound_by}, share {bound_ms / ms:.3f}), one PyTorch call {lib_note}")
        entries.append({
            "name": f"{name} n={n}{f' m={m}' if m else ''} bfloat16", "route": "cuda",
            "source": K2_SOURCE, "replaces": e.replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": (p1 + p2) / 2,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        })
        del sets, args
    log(f"phase 7: bfloat16 took {time.perf_counter() - t_phase:.1f} s")


def _quiet(fn):
    """``(fn(), its standard output)``: an example's printout kept from the
    run's log."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn()
    return result, out.getvalue()


def phase_tools_checks(dev, summary):
    """Phase 20 (c), in the second process after phase 19's checks: the
    host-bound tools, their rates recorded and never claimed.  The ensemble
    sweep at its gauss4 default on 16384 members (cut to
    ``SWEEP_GAUSS4_STEPS``), ``hmc.main`` at 16384 chains with its exact K2
    launches, and the CLI headless in this process, each final state against
    the same run on the CPU."""
    import torch
    from hamilton_tpu_torch import cli, kernels
    from hamilton_tpu_torch.examples import ensemble_sweep, hmc

    t_phase = time.perf_counter()
    argv = ["--batch", str(BATCH), "--steps", str(SWEEP_GAUSS4_STEPS), "--device", "cuda",
            "--json"]
    t0 = time.perf_counter()
    (rc, text), counts = counted(lambda: _quiet(lambda: ensemble_sweep.main(argv)))
    el = time.perf_counter() - t0
    out = json.loads(text.strip().splitlines()[-1])
    # n = 2: the double pendulum's solves are below the K2 entries' n >= 3,
    # so its library path launches no hand-written kernel
    expect_counts("ensemble_sweep gauss4", counts)
    if rc != 0 or not all(math.isfinite(out[k]) for k in
                          ("lyapunov_mean", "lyapunov_max", "max_energy_drift")):
        raise AssertionError(f"ensemble_sweep gauss4: exit {rc}, {out}")
    log(f"phase 20 (c): ensemble_sweep gauss4 {BATCH} x double pendulum float32, "
        f"{SWEEP_GAUSS4_STEPS} steps (cut from 20000: host-bound, ~7 ham_eqs a step), "
        f"{el:.1f} s in all: {out['member_steps_per_sec']:.6e} member-steps/s (recorded, not "
        f"claimed), lambda mean {out['lyapunov_mean']:.4f}, max|dH/H0| "
        f"{out['max_energy_drift']:.6e}, launches {counts}")
    summary["sweep_gauss4_member_steps_per_sec"] = out["member_steps_per_sec"]

    t0 = time.perf_counter()
    (rc, text), counts = counted(lambda: _quiet(lambda: hmc.main(HMC_ARGV)))
    el = time.perf_counter() - t0
    # J route (identity coordinates, no mass matrix): a step factors K from
    # sqrt(M) J (K2e) and solves with the factor three times (K2c); each
    # iteration's two hamiltonians and the leapfrog's velocity solve K2d
    want = dict(cholesky_jac=HMC_ITERS * (HMC_L + 1), cho_solve=HMC_ITERS * 3 * HMC_L,
                spd_solve_jac=HMC_ITERS * (HMC_L + 2))
    expect_counts("hmc", counts, **want)
    if rc != 0:
        raise AssertionError(f"hmc.main returned {rc}:\n{text}")
    log(f"phase 20 (c): hmc {' '.join(HMC_ARGV)}: exit 0, {el:.1f} s "
        f"({el / HMC_ITERS * 1e3:.1f} ms an iteration of {HMC_L} leapfrog steps), launches "
        f"{counts}; " + " | ".join(text.strip().splitlines()[1:4]))
    summary["hmc_launches"] = {k: v for k, v in counts.items() if v}
    summary["hmc_seconds"] = el

    for label, argv, frames in CLI_RUNS:
        states = {}
        for where in ("cuda", "cpu"):
            args = cli.build_parser().parse_args(["--device", where] + argv)
            ex = cli._example_from_args(args)
            step = cli._make_step(ex, args.method, args.dt)
            ph = ex.init_phase
            t0 = time.perf_counter()
            if where == "cuda":
                torch.cuda.synchronize()
                before = kernels.launch_counts()
            for _ in range(frames):
                ph = step(ph, 1.0 / cli.FPS)
            if where == "cuda":
                torch.cuda.synchronize()
                launched = {k: v - before[k] for k, v in kernels.launch_counts().items()
                            if v - before[k]}
            states[where] = (ph, (time.perf_counter() - t0) / frames)
        (card, s_card), (cpu, s_cpu) = states["cuda"], states["cpu"]
        err = max(float((card.q.cpu() - cpu.q).abs().max()),
                  float((card.p.cpu() - cpu.p).abs().max()))
        log(f"phase 20 (c): cli {label}, {frames} frames: card vs CPU {err:.3e}; "
            f"{s_card:.3f} s a frame on the card, {s_cpu:.3f} on the CPU (the loop aims at "
            f"{1 / cli.FPS:.4f}); launches {launched}")
        if not err <= CPU_TOL_F64:
            raise AssertionError(f"cli {label}: card and CPU differ by {err:.3e}")
        summary[f"cli_{label.replace(' ', '_').replace('=', '')}_s_per_frame"] = s_card
    log(f"phase 20 (c): took {time.perf_counter() - t_phase:.1f} s")


def phase_tools(dev, entries, summary):
    """Phase 20, the tools and examples in this process: (a) chaos_scan
    --fused at 16384 pair members, its first launch against the plain
    version, K1 timed at its shape; (b) ensemble_sweep --method
    leapfrog_fused at BASELINE configs[4]'s size; (d) a Poincaré section of
    a 16384-member trajectory on the card against the CPU's, a guarded
    50-step loop that never synchronizes, a checkpoint from the card resumed
    bit for bit; and hmc's K2 kernels timed at its shape."""
    import torch
    from hamilton_tpu_torch.ensemble import evolve_ensemble
    from hamilton_tpu_torch.examples import chaos_scan, ensemble_sweep
    from hamilton_tpu_torch.examples import hmc
    from hamilton_tpu_torch.integrators.fixed import make_stepper
    from hamilton_tpu_torch.models import double_pendulum
    from hamilton_tpu_torch.ops.batched_spd import ENTRIES
    from hamilton_tpu_torch.ops.fused_step import (
        fused_step_kernel, fused_step_reference, fused_stepper,
    )
    from hamilton_tpu_torch.state import Phase
    from hamilton_tpu_torch.utils import roofline as rl
    from hamilton_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from hamilton_tpu_torch.utils.diagnostics import CheckError, checked, nan_guard
    from hamilton_tpu_torch.utils.poincare import coordinate_section, poincare_section
    from hamilton_tpu_torch.utils.profiling import time_queued

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64

    # (a) chaos_scan --fused: exactly 100 K1 launches and nothing else
    t0 = time.perf_counter()
    (rc, text), counts = counted(lambda: _quiet(lambda: chaos_scan.main(CHAOS_ARGV)))
    el = time.perf_counter() - t0
    expect_counts("chaos_scan --fused", counts, fused_step=CHAOS_LAUNCHES)
    lines = text.strip().splitlines()
    if rc != 0:
        raise AssertionError(f"chaos_scan returned {rc}:\n{text}")
    log(f"phase 20 (a): chaos_scan {' '.join(CHAOS_ARGV)}: exit 0 in {el:.2f} s, "
        f"{counts['fused_step']} K1 launches; " + " | ".join(lines[1:3] + lines[-1:]))
    system, pairs, _, _ = chaos_scan.chaos_setup(64, 128, eps=1e-4, device=dev, dtype=f32)
    forms = system.fused_forms(system)
    state, table = fused_stepper(forms, iters=(3, 1), steps_per_call=40).init(pairs)
    kw = dict(iters=(3, 1), compensated=False, steps_per_call=40, coef=table)

    def kern():
        return fused_step_kernel(forms, state, 5e-3, **kw)

    def plain():
        return fused_step_reference(forms, state, 5e-3, **kw)

    members = pairs.q.shape[0]
    p1, p_out = time_call(plain, 1)
    worst, errs, failures = compare_states(kern(), p_out, "float32", CHAOS_TOL)
    log(f"phase 20 {'FAILED' if failures else 'ok'}: (a) chaos_scan's first 40-step launch, "
        f"{members} x dense n=2 float32 (3,1) per-member tables, kernel vs plain (largest "
        f"|q|, |p| {float(p_out[:2].abs().max()):.3f}; limits {CHAOS_TOL}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if failures:
        raise AssertionError("chaos_scan's launch disagrees with its plain version: "
                             + "; ".join(failures))
    k1, _ = time_queued(kern, 100)
    k2, _ = time_queued(kern, 100)
    p2, _ = time_call(plain, 1)
    bound_ms, bound_by, _ = k1_bound(system, "leapfrog_fused", (3, 1), False, members, 40)
    log(f"phase 20 (a): K1 at chaos_scan's shape {(k1 + k2) / 2:.5f} ms a 40-step launch "
        f"({k1:.5f}, {k2:.5f}), plain {(p1 + p2) / 2:.2f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by})")
    entries.append({
        "name": "fused_step dense n=2 float32 (3,1) per-member tables, 40 steps a launch "
                "(chaos_scan --fused)", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": CHAOS_LAUNCHES, "max_abs_err": worst, "ms": (k1 + k2) / 2,
        "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    })
    del state, table, p_out
    t_part = time.perf_counter()
    log(f"phase 20: (a) took {t_part - t_phase:.1f} s")

    # (b) ensemble_sweep --method leapfrog_fused: one step a launch (its
    # evolve_ensemble's steps_per_call is 1), the run and its twin: exactly
    # 2 x 20000 K1 launches, no K2 (n = 2)
    (rc, text), counts = counted(lambda: _quiet(lambda: ensemble_sweep.main(SWEEP_ARGV)))
    out = json.loads(text.strip().splitlines()[-1])
    expect_counts("ensemble_sweep leapfrog_fused", counts, fused_step=SWEEP_LAUNCHES)
    fields = ("lyapunov_mean", "lyapunov_max", "chaotic_fraction", "max_energy_drift")
    if rc != 0 or not all(math.isfinite(out[k]) for k in fields) or out["devices"] != 1:
        raise AssertionError(f"ensemble_sweep leapfrog_fused: exit {rc}, {out}")
    log(f"phase 20 (b): ensemble_sweep {' '.join(SWEEP_ARGV)}: {out['member_steps_per_sec']:.6e} "
        f"member-steps/s, lambda mean {out['lyapunov_mean']:.4f} max {out['lyapunov_max']:.4f}, "
        f"chaotic {out['chaotic_fraction']:.4f} (by m2 "
        f"{[round(f, 3) for f in out['chaotic_fraction_by_mass']]}), max|dH/H0| "
        f"{out['max_energy_drift']:.6e}, {counts['fused_step']} K1 launches; "
        f"{time.perf_counter() - t_part:.1f} s")
    summary["sweep_fused_member_steps_per_sec"] = out["member_steps_per_sec"]
    summary["sweep_fused_max_drift"] = out["max_energy_drift"]
    t_part = time.perf_counter()

    # (d) the utilities on the card
    dp = double_pendulum(device=dev, dtype=f64)
    ph = jittered_phase(dp, BATCH, f64, dev, 20)
    traj = evolve_ensemble(dp.system, ph, 1e-2, POINCARE_STEPS, method="leapfrog_fused",
                           iters=(2, 1), emit_every=POINCARE_EMIT)
    pts, valid = poincare_section(traj, coordinate_section(0), max_crossings=POINCARE_CAP)
    cpu_traj = Phase(traj.q.cpu(), traj.p.cpu())
    cpu_pts, cpu_valid = poincare_section(cpu_traj, coordinate_section(0),
                                          max_crossings=POINCARE_CAP)
    err = max(float((pts.q.cpu() - cpu_pts.q).abs().max()),
              float((pts.p.cpu() - cpu_pts.p).abs().max()))
    same_mask = torch.equal(valid.cpu(), cpu_valid)
    log(f"phase 20 {'ok' if same_mask and err <= PHYSICS_TOL else 'FAILED'}: (d) poincare_section "
        f"of a {tuple(traj.q.shape)} float64 trajectory on the card vs the CPU: {err:.3e}, masks "
        f"{'equal' if same_mask else 'DIFFER'}, {int(valid.sum())} crossings, "
        f"{int(valid.all(0).sum())} members at the cap {POINCARE_CAP}")
    if not (same_mask and err <= PHYSICS_TOL):
        raise AssertionError("poincare_section on the card differs from the CPU's")
    del traj, cpu_traj

    dp32 = double_pendulum(device=dev, dtype=f32)
    st = make_stepper(dp32.system, "leapfrog_fused", iters=(2, 1))
    ph32 = ph.astype(f32)
    poison = torch.zeros(BATCH, 1, dtype=f32, device=dev)
    poison[5] = float("nan")

    def guarded(ph, bad_at):
        carry = st.init(ph)
        for i in range(GUARD_STEPS):
            if i == bad_at:  # the poison, outside the watched step
                phi = st.extract(carry)
                carry = st.init(Phase(phi.q + poison, phi.p))
            torch.cuda.set_sync_debug_mode("error")  # any host read in here raises
            try:
                carry = st.step(carry, 1e-3)
                nan_guard(st.extract(carry), f"step {i}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return st.extract(carry)

    st.step(st.init(ph32), 1e-3)  # the stepper's first step uploads its table
    clean = checked(guarded)(ph32, -1)
    try:
        checked(guarded)(ph32, 31)
    except CheckError as exc:
        message = str(exc)
    else:
        message = None
    if not all_finite(clean.q, clean.p) or message != "non-finite state detected at step 31":
        raise AssertionError(f"guarded loop: clean finite {all_finite(clean.q, clean.p)}, "
                             f"poisoned run raised {message!r}")
    log(f"phase 20 ok: (d) {GUARD_STEPS}-step guarded fused loop on {BATCH} members under "
        f"torch.cuda.set_sync_debug_mode('error'): no host read until checked returned; the "
        f"member poisoned at step 31 raised {message!r}")

    path = str(REPO / "chiprun_out" / "phase20_checkpoint.npz")
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    carry = st.init(ph32)
    for _ in range(25):
        carry = st.step(carry, 1e-3)
    save_checkpoint(path, carry, step=25)
    straight = carry
    for _ in range(25):
        straight = st.step(straight, 1e-3)
    resumed, step, _ = load_checkpoint(path, like=carry)
    for _ in range(GUARD_STEPS - step):
        resumed = st.step(resumed, 1e-3)
    a, b = st.extract(straight), st.extract(resumed)
    same = torch.equal(a.q, b.q) and torch.equal(a.p, b.p)
    os.remove(path)
    log(f"phase 20 {'ok' if same else 'FAILED'}: (d) checkpoint of the fused carry saved from "
        f"the card at step 25 and resumed to step {GUARD_STEPS}: "
        f"{'bit for bit' if same else 'DIFFERS'} the straight run")
    if not same:
        raise AssertionError("the resumed run differs from the straight run")
    log(f"phase 20: (d) took {time.perf_counter() - t_part:.1f} s")

    # hmc's kernels at its shape (16384 chains, n = m = 3, float32), with the
    # second process's launches
    launches = summary.pop("hmc_launches")
    gsys = hmc.gaussian_system(dev, f32)
    g = torch.Generator(device=dev).manual_seed(20)
    q = torch.randn((BATCH, 3), generator=g, device=dev)
    p = torch.randn((BATCH, 3), generator=g, device=dev)
    from hamilton_tpu_torch.mechanics import _jacobian
    from hamilton_tpu_torch.ops.batched_spd import jac_scaled

    js = jac_scaled(_jacobian(gsys, q), gsys.inertia)
    by_name = {e.name: e for e in ENTRIES}
    low = by_name["cholesky_jac"].plain(js)
    for name, args, launch in (("cholesky_jac", (js,), "cholesky_jac"),
                               ("cho_solve_batched", (low, p), "cho_solve"),
                               ("spd_solve_jac", (js, p), "spd_solve_jac")):
        e = by_name[name]
        got, want = e.kernel(*args), e.plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= K2_TOL:
            raise AssertionError(f"{name} at hmc's shape: kernel differs from plain by {err}")
        p1, _ = time_call(lambda: e.plain(*args), 2)
        k1, _ = time_queued(lambda: e.kernel(*args), 100)
        k2, _ = time_queued(lambda: e.kernel(*args), 100)
        p2, _ = time_call(lambda: e.plain(*args), 2)
        ops, nbytes = k2_work(e, BATCH, 3, 3 if e.from_jac else 0, f32)
        bound_ms, bound_by = rl.bound(ops, nbytes, f32)
        log(f"phase 20: {name} at hmc's shape {BATCH} x n=3{' m=3' if e.from_jac else ''} "
            f"float32: kernel {(k1 + k2) / 2:.5f} ms ({k1:.5f}, {k2:.5f}), plain "
            f"{(p1 + p2) / 2:.3f} ms, bound {bound_ms:.6f} ms ({bound_by}), "
            f"{launches[launch]} launches in hmc's run")
        entries.append({
            "name": f"{name} n=3{' m=3' if e.from_jac else ''} float32 (hmc, {BATCH} chains)",
            "route": "cuda", "source": K2_SOURCE, "replaces": e.replaces,
            "launches": launches[launch], "max_abs_err": err, "ms": (k1 + k2) / 2,
            "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    log(f"phase 20: {time.perf_counter() - t_phase:.1f} s in this process")


def _niced(fn, *args):
    """``fn(*args)`` at a lower priority: on Linux the nice value is the
    calling thread's, and the threads and nvcc processes it starts inherit
    it, so these builds take the cores the phases leave idle."""
    os.nice(10)
    return fn(*args)


def phase21_builds(dev, pool):
    """Start in ``pool`` the builds that only phase 21 (a) needs, so that
    they compile beside the first build and phases 1-20, at a lower priority
    (:func:`_niced`): each case's kernel as ``KERNEL_INSTANTIATIONS`` routes
    it, its source's float32 and float64 parts (``csrc/fused_step.cu``'s
    dense lane kernels, ``csrc/semisep_wide.cu``: a minute or two each) or
    its generated header (six parts).  Returns ``({label: future}, the
    units to leave out of the first build)``."""
    import torch
    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.models import chain
    from hamilton_tpu_torch.ops import fused_codegen
    from hamilton_tpu_torch.ops.fused_step import KERNEL_INSTANTIATIONS, _kernel_key

    futures, exclude = {}, []
    for label, n, solver, *_ in CHAIN_CASES:
        system = chain(n_links=n, fused_solver=solver, device=dev, dtype=torch.float32).system
        forms = system.fused_forms(system)
        if _kernel_key(forms) in KERNEL_INSTANTIATIONS:
            source, code = KERNEL_INSTANTIATIONS[_kernel_key(forms)]
            parts = tuple(kernels.PARTS[source][1](d, code, solver == "semiseparable")
                          for d in (0, 1))
            exclude += [(source, part) for part in parts]
            futures[label] = pool.submit(_niced, kernels.build, source, parts)
        else:
            futures[label] = pool.submit(_niced, kernels.build_user_family,
                                         fused_codegen.generated(forms).header)
    return futures, exclude


def phase_chain_checks(dev, late_builds):
    """Phase 21 (a)'s checks, run at the end of phase 1 while phase 19's
    checks finish in the second process (they time nothing): for each of
    :data:`CHAIN_CASES`, wait for its kernel as ``KERNEL_INSTANTIATIONS``
    routes it (``csrc/fused_step.cu``'s parts, or the generated kernel),
    built beside the first build (``late_builds``, :func:`phase21_builds`),
    and log its build seconds, registers, stack frames and spills; hold the
    kernel against its plain version at :data:`CHAIN_CASE_BATCHES` in
    float64 and float32 (one plain run on the members of both batches), bit
    for bit on the hand-written kernels; the dense chain at n = 20 and the
    semiseparable one at n = 40 also in :data:`CHAIN_MODES`
    (:func:`mode_checks`).  Returns ``{label: (launch counter, source, nvcc
    seconds, largest float32 q/p error)}``."""
    import torch
    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.models import chain
    from hamilton_tpu_torch.ops.fused_step import (
        KERNEL_INSTANTIATIONS, _kernel_key, fused_step_kernel, fused_step_reference,
        fused_stepper,
    )

    f32 = torch.float32
    checked = {}
    for label, n, solver, iters, dt, steps, spc_check, drift_bound in CHAIN_CASES:
        system = chain(n_links=n, fused_solver=solver, device=dev, dtype=f32).system
        route = KERNEL_INSTANTIATIONS.get(_kernel_key(system.fused_forms(system)))
        hand = route is not None
        t_wait = time.perf_counter()
        build = late_builds[label].result()
        waited = time.perf_counter() - t_wait
        if hand:
            counter = route[0]
            source = {"semisep_wide": WIDE_SOURCE}.get(
                counter, SOURCE if solver != "dense" else DENSE_SOURCE)
            pattern, namer = ((_WIDE_RE, _wide_label) if counter == "semisep_wide"
                              else (_KERNEL_RE, _k1_label))
            seconds = list(build.part_seconds)
            regs = ptxas_report(build.log, pattern, namer)
            frames = ptxas_frames(build.log, pattern, namer)
            built = (f"csrc/{counter}.cu's float32 and float64 parts: nvcc "
                     + " s and ".join(f"{x:.1f}" for x in seconds) + " s")
        else:
            counter, source = "user_family", USER_SOURCE
            key, build = build
            seconds = [build.seconds]
            regs = ptxas_report(build.log, _USER_RE, _user_label)
            frames = ptxas_frames(build.log, _USER_RE, _user_label)
            built = f"the generated kernel ({key}): nvcc {build.seconds:.1f} s"
        if hand and (solver == "dense" or counter == "semisep_wide"):
            layouts = [kernels.lane_layout(counter, d, n, semiseparable=solver != "dense")
                       for d in (0, 1)]
            built += ", " + ", ".join(
                f"{t}: {lanes} lanes a member, {block} threads and {smem} B of shared memory "
                f"a block, {blocks} blocks an SM" for t, (lanes, block, smem, blocks)
                in zip(("float", "double"), layouts))
        log(f"phase 21 (a) {label}: {built} (waited {waited:.1f} s for it), {len(regs)} "
            f"instantiations, registers {min(r[1] for r in regs)}-{max(r[1] for r in regs)}, "
            f"spill stores {min(r[2] for r in regs)}-{max(r[2] for r in regs)} B")
        for kname, nreg, st, ld in regs:
            log(f"ptxas: {label}: {kname:<45} {nreg:3d} registers, stack frame "
                f"{frames.get(kname, (0,))[0]} B, spill stores {st} B, spill loads {ld} B")

        # the kernel against its plain version, one plain run for both batches
        worst = 0.0
        for dtype in (torch.float64, f32):
            dname = str(dtype).split(".")[-1]
            exd = chain(n_links=n, fused_solver=solver, device=dev, dtype=dtype)
            fd = exd.system.fused_forms(exd.system)
            st = fused_stepper(fd, iters=iters, compensated=True, steps_per_call=spc_check)
            states = [st.init(jittered_phase(exd, b, dtype, dev, 21 + i))
                      for i, b in enumerate(CHAIN_CASE_BATCHES)]
            kw = dict(iters=iters, compensated=True, steps_per_call=spc_check)
            t0 = time.perf_counter()
            plain = fused_step_reference(fd, torch.cat(states, dim=2), dt, **kw)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            start, failures = 0, []
            for b, state in zip(CHAIN_CASE_BATCHES, states):
                got = fused_step_kernel(fd, state, dt, **kw)
                torch.cuda.synchronize()
                want = plain[:, :, start:start + b]
                err, errs, bad = compare_states(got, want, dname)
                start += b
                worst = max(worst, err) if dtype == f32 else worst
                if hand and not torch.equal(got, want):
                    bad = bad + ["not bitwise"]
                failures += bad
                log(f"phase 21 (a) {'FAILED' if bad else 'ok'}: {label} {dname} B={b} "
                    f"spc={spc_check}: bitwise {torch.equal(got, want)}, "
                    + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
            log(f"phase 21 (a): {label} {dname}: one plain run of {spc_check} steps on "
                f"{sum(CHAIN_CASE_BATCHES)} members took {plain_s:.1f} s")
            if failures:
                raise AssertionError(f"{label}: kernel disagrees with its plain version: "
                                     + "; ".join(failures))
        if hand and (solver, n) in MODE_CHECKS:
            mode_checks(dev, solver, n)
        checked[label] = (counter, source, max(seconds), worst)
    return checked


def mode_checks(dev, solver, n):
    """The chain's kernel with ``solver``'s forms at ``n`` in
    :data:`CHAIN_MODES` (a per-member table, a composition), each dtype, on
    the batches and over the steps :data:`MODE_CHECKS` gives: bit for bit
    the plain version, or the run fails."""
    import numpy as np
    import torch
    from hamilton_tpu_torch.convert import params_from_numpy
    from hamilton_tpu_torch.models import chain
    from hamilton_tpu_torch.ops.fused_step import (
        SUZUKI4_COMPOSITION, fused_step_kernel, fused_step_reference, fused_stepper,
    )

    batches, steps = MODE_CHECKS[(solver, n)]
    cases = [(b, dtype, mode) for b in batches for dtype in (torch.float64, torch.float32)
             for mode in CHAIN_MODES]
    for b, dtype, (mode, iters, comp, swept, composition) in cases:
        dname = str(dtype).split(".")[-1]
        composition = SUZUKI4_COMPOSITION if composition == "suzuki4" else composition
        ex = chain(n_links=n, fused_solver=solver, device=dev, dtype=dtype)
        system = ex.system
        if swept:
            rng = np.random.default_rng(n)
            system = system.replace_params(params_from_numpy({
                "masses": 1.0 + 0.05 * rng.standard_normal((b, n)),
                "lengths": 1.0 + 0.1 * rng.random((b, n)),
                "gravity": 9.8 + 0.1 * rng.standard_normal(b)}, device=dev, dtype=dtype))
        forms = system.fused_forms(system)
        kw = dict(iters=iters, compensated=comp, steps_per_call=steps,
                  composition=composition)
        carry = fused_stepper(forms, **kw).init(jittered_phase(ex, b, dtype, dev, 22))
        state, table = carry if swept else (carry, None)
        got = fused_step_kernel(forms, state, 1e-3, coef=table, **kw)
        want = fused_step_reference(forms, state, 1e-3, coef=table, **kw)
        torch.cuda.synchronize()
        _, errs, bad = compare_states(got, want, dname)
        bitwise = torch.equal(got, want)
        log(f"phase 21 (a) {'ok' if bitwise and not bad else 'FAILED'}: {solver} n={n} "
            f"{mode} {dname} B={b} spc={steps}: bitwise {bitwise}, "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if bad or not bitwise:
            raise AssertionError(f"{solver} n={n} {mode} {dname}: the kernel differs "
                                 f"from its plain version: " + "; ".join(bad))


def phase_chain_cases(dev, checked, entries, summary):
    """Phase 21 (a): :data:`CHAIN_CASES` on K1, each on the kernel
    :func:`phase_chain_checks` built and checked (``checked``): the run
    through ``evolve_ensemble_final`` with its exact launches, member-steps/s
    and float64 drift; the 50-step launch's device ms against the plain
    version's, the bound and its share."""
    import torch
    from hamilton_tpu_torch.ensemble import evolve_ensemble_final
    from hamilton_tpu_torch.models import chain
    from hamilton_tpu_torch.ops.batched_spd import MAX_N
    from hamilton_tpu_torch.ops.fused_step import (
        coef_table, fused_step_kernel, fused_step_reference, fused_stepper,
    )
    from hamilton_tpu_torch.utils.profiling import time_queued

    f32, spc = torch.float32, 50
    for label, n, solver, iters, dt, steps, spc_check, drift_bound in CHAIN_CASES:
        semi = solver == "semiseparable"
        ex = chain(n_links=n, fused_solver=solver, device=dev, dtype=f32)
        forms = ex.system.fused_forms(ex.system)
        counter, source, nvcc_s, worst = checked[label]
        hand = counter != "user_family"

        # the run
        ph = jittered_phase(ex, BATCH, f32, dev, 0)
        run_kw = dict(method="leapfrog_fused", iters=iters, compensated=True,
                      drift_every=1000, drift_dtype=torch.float64, steps_per_call=spc)
        evolve_ensemble_final(ex.system, ph, dt, 1000, **run_kw)  # the table's upload
        t0 = time.perf_counter()
        (final, drift), counts = counted(lambda: evolve_ensemble_final(
            ex.system, ph, dt, steps, **run_kw))
        wall = time.perf_counter() - t0
        # the float64 sampler solves with K2a where n <= MAX_N (else torch.linalg)
        want = {counter: steps // spc}
        if n <= MAX_N:
            want["spd_solve"] = 1 + steps // 1000
        expect_counts(label, counts, **want)
        if not all_finite(final.q, final.p, drift) or tuple(final.q.shape) != (BATCH, n):
            raise AssertionError(f"{label}: output not finite or not ({BATCH}, {n})")
        rate, max_drift = BATCH * steps / wall, float(drift.max())

        # the launch, timed
        state = fused_stepper(forms, iters=iters, compensated=True, steps_per_call=spc).init(ph)
        coef = coef_table(forms, dev, f32)
        kw = dict(iters=iters, compensated=True, steps_per_call=spc)

        def kern():
            return fused_step_kernel(forms, state, dt, coef=coef, **kw)

        k_out = kern()
        p_ms, p_out = time_call(lambda: fused_step_reference(forms, state, dt, **kw), 1)
        reps = 20 if n == 40 and not semi else 100
        k1, h1 = time_queued(kern, reps)
        k2, h2 = time_queued(kern, reps)
        err, errs, bad = compare_states(k_out, p_out, "float32")
        if bad:
            raise AssertionError(f"{label} B={BATCH}: kernel disagrees with its plain version: "
                                 + "; ".join(bad))
        ms = (k1 + k2) / 2
        bound_ms, bound_by, cost = k1_bound(ex.system, "leapfrog_fused", iters, True, BATCH, spc)
        launches = counts[counter]
        log(f"phase 21 (a) ok: {label} 16384 float32 kahan dt={dt}, {steps} steps on the "
            f"{'hand-written' if hand else 'generated'} kernel: {rate:.6e} member-steps/s "
            f"({wall:.3f} s), max|dH/H0| {max_drift:.6e}"
            + (f" (bound {drift_bound:.0e})" if drift_bound else " (recorded)")
            + f", launches {counts}; kernel {ms:.4f} ms a launch ({k1:.4f}, {k2:.4f}), host "
            f"{(h1 + h2) / 2 * 1e3:.2f} us to issue one, plain {p_ms:.2f} ms, bound "
            f"{bound_ms:.6f} ms ({bound_by}; {cost['flops_per_member_step']:.2f} flops, "
            f"{cost['transcendentals_per_member_step']:.2f} transcendentals a member-step), "
            f"share {bound_ms / ms:.4f}, launches x gap {launches * (ms - bound_ms) / 1e3:.6f} s; "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if drift_bound is not None and not max_drift < drift_bound:
            raise AssertionError(f"{label} drift {max_drift:.3e} >= {drift_bound}")
        tag = f"chain_{solver}{n}"
        summary.update({f"{tag}_member_steps_per_sec": rate, f"{tag}_max_drift": max_drift,
                        f"{tag}_steps": steps, f"{tag}_nvcc_s": nvcc_s})
        entries.append({
            "name": f"{counter} {solver} n={n} float32 kahan ({iters[0]},{iters[1]}) (phase 21)",
            "route": "cuda", "source": source, "replaces": REPLACES, "launches": launches,
            "max_abs_err": max(worst, err), "ms": ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        del state, k_out, p_out, final, drift


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_sharded(dev, summary):
    """Phase 21 (b): ``evolve_ensemble_sharded`` on the headline's
    configuration (16384 × chain-20 semiseparable, float32 (2,0) Kahan,
    dt = 5e-4, :data:`SHARD_STEPS` steps, float64 drift every 1000) on a
    one-device mesh, on :data:`SHARD_COUNT` shards on the card and, where the
    machine has more cards, over all of them: bitwise the unsharded
    ``evolve_ensemble_final``'s final state and drift, with exact launches;
    ``reduce_stats`` through a world-size-1 NCCL group opened by
    ``init_distributed`` on localhost; the dense chain-20 (phase 21 (a)'s
    route) sharded; a DCP round trip of the shards, bitwise."""
    import tempfile

    import torch
    import torch.distributed as dist
    from hamilton_tpu_torch import parallel
    from hamilton_tpu_torch.ensemble import evolve_ensemble_final, evolve_ensemble_sharded
    from hamilton_tpu_torch.models import chain
    from hamilton_tpu_torch.ops.fused_step import KERNEL_INSTANTIATIONS, _kernel_key
    from hamilton_tpu_torch.utils import load_orbax, save_orbax

    f32, spc = torch.float32, 50
    launches = SHARD_STEPS // spc
    samples = 1 + SHARD_STEPS // 1000
    kw = dict(method="leapfrog_fused", iters=(2, 0), compensated=True, drift_every=1000,
              drift_dtype=torch.float64, steps_per_call=spc)
    ex = chain(n_links=20, fused_solver="semiseparable", device=dev, dtype=f32)
    ph = jittered_phase(ex, BATCH, f32, dev, 0)
    t0 = time.perf_counter()
    (ref, ref_drift), counts = counted(lambda: evolve_ensemble_final(
        ex.system, ph, 5e-4, SHARD_STEPS, **kw))
    ref_s = time.perf_counter() - t0
    expect_counts("unsharded", counts, fused_step=launches, spd_solve=samples)

    def same(final, drift):
        return (torch.equal(final.q, ref.q) and torch.equal(final.p, ref.p)
                and torch.equal(drift, ref_drift))

    cards = torch.cuda.device_count()
    meshes = [("one-device mesh", [dev]), (f"{SHARD_COUNT}-shard mesh on {dev}",
                                           [dev] * SHARD_COUNT)]
    if cards > 1:
        meshes.append((f"mesh over the {cards} cards",
                       [torch.device("cuda", i) for i in range(cards)]))
    log(f"phase 21 (b): the machine has {cards} card(s); unsharded run {ref_s:.3f} s")
    for label, devices in meshes:
        mesh = parallel.ensemble_mesh(devices)
        t0 = time.perf_counter()
        (final, drift), counts = counted(lambda: evolve_ensemble_sharded(
            ex.system, ph, 5e-4, SHARD_STEPS, mesh=mesh, **kw))
        el = time.perf_counter() - t0
        expect_counts(label, counts, fused_step=launches * len(devices),
                      spd_solve=samples * len(devices))
        ok = same(final, drift)
        log(f"phase 21 (b) {'ok' if ok else 'FAILED'}: evolve_ensemble_sharded on the {label} "
            f"({len(devices)} shards): {el:.3f} s, {BATCH * SHARD_STEPS / el:.6e} member-steps/s, "
            f"final state and per-member drift bitwise the unsharded run's: {ok}, launches "
            f"{counts}")
        if not ok:
            raise AssertionError(f"sharded on the {label} differs from the unsharded run")
        summary[f"sharded_{len(devices)}_member_steps_per_sec"] = BATCH * SHARD_STEPS / el
    summary["sharded_cards"] = cards

    # reduce_stats through a world-size-1 NCCL group
    torch.cuda.set_device(dev)
    port = _free_port()
    if not parallel.init_distributed(f"localhost:{port}", 1, 0, timeout=120):
        raise AssertionError("init_distributed did not open the group")
    try:
        backend = dist.get_backend()
        mesh4 = parallel.global_ensemble_mesh(devices=[dev] * SHARD_COUNT)
        (final, dmax), counts = counted(lambda: evolve_ensemble_sharded(
            ex.system, ph, 5e-4, SHARD_STEPS, mesh=mesh4, reduce_stats="max", **kw))
        _, dmean = evolve_ensemble_sharded(ex.system, ph, 5e-4, SHARD_STEPS, mesh=mesh4,
                                           reduce_stats="mean", **kw)
        want_mean = float(torch.stack([d.mean() for d in ref_drift.chunk(SHARD_COUNT)]).sum()
                          / SHARD_COUNT)
        ok = (float(dmax) == float(ref_drift.max()) and dmax.ndim == 0
              and abs(float(dmean) - want_mean) <= 1e-15 * want_mean)
        log(f"phase 21 (b) {'ok' if ok else 'FAILED'}: reduce_stats through a world-size-1 "
            f"{backend} group on localhost:{port}: max {float(dmax):.6e} (unsharded max "
            f"{float(ref_drift.max()):.6e}), mean {float(dmean):.6e} (the shards' means "
            f"{want_mean:.6e}), launches {counts}")
        if not ok or backend != "nccl":
            raise AssertionError("reduce_stats over NCCL differs from the unsharded drift")
        # a DCP round trip of the sharded final state, in the group
        shards = parallel.shard_phase(ref, parallel.ensemble_mesh([dev] * SHARD_COUNT))
        with tempfile.TemporaryDirectory() as where:
            t0 = time.perf_counter()
            save_orbax(os.path.join(where, "final"), shards)
            back = load_orbax(os.path.join(where, "final"), like=shards)
            el = time.perf_counter() - t0
        ok = all(torch.equal(a.q, b.q) and torch.equal(a.p, b.p)
                 for a, b in zip(shards.shards, back.shards))
        log(f"phase 21 (b) {'ok' if ok else 'FAILED'}: save_orbax/load_orbax (DCP) of the "
            f"{SHARD_COUNT} shards of the final state, {el:.3f} s: bitwise {ok}")
        if not ok:
            raise AssertionError("the DCP round trip changed the shards")
    finally:
        dist.destroy_process_group()

    # the dense chain-20 sharded, on phase 21 (a)'s route
    label, n, solver, iters, dt, *_ = CHAIN_CASES[0]
    exd = chain(n_links=n, fused_solver=solver, device=dev, dtype=f32)
    phd = jittered_phase(exd, BATCH, f32, dev, 0)
    counter = ("fused_step" if _kernel_key(exd.system.fused_forms(exd.system))
               in KERNEL_INSTANTIATIONS else "user_family")
    kwd = dict(kw, iters=iters)
    ref, ref_drift = evolve_ensemble_final(exd.system, phd, dt, SHARD_STEPS, **kwd)
    (final, drift), counts = counted(lambda: evolve_ensemble_sharded(
        exd.system, phd, dt, SHARD_STEPS, mesh=parallel.ensemble_mesh([dev] * SHARD_COUNT),
        **kwd))
    expect_counts(f"{label} sharded", counts, **{counter: launches * SHARD_COUNT},
                  spd_solve=samples * SHARD_COUNT)
    ok = same(final, drift)
    log(f"phase 21 (b) {'ok' if ok else 'FAILED'}: {label} on {SHARD_COUNT} shards ({counter}): "
        f"bitwise the unsharded run's: {ok}, launches {counts}")
    if not ok:
        raise AssertionError(f"{label} sharded differs from the unsharded run")


def phase_native_oracle(dev, ex64, ph64a, out64, summary):
    """Phase 9 (b), (c): the native C++ engine (``hamilton_tpu_torch.native``,
    built from ``native/hamode.cpp`` here) against the card.  (b) the parity
    triangle: the port's float64 ``evolve_ham(method="rkf45")`` of the double
    pendulum on the card, the engine driving the port's ``ham_rhs`` on the
    card (``y`` to the card and its derivative back each stage) and the
    engine's closed-form double pendulum, pairwise within ``TRIANGLE_TOL``;
    (c) ``ORACLE_MEMBERS`` members of phase 8's float64 run (``ex64``'s chain
    from ``ph64a`` to ``out64`` at t = 1, no second card run) against
    ``native.chain_evolve`` from the same state with the chain's masses,
    link length and gravity at eps ``ORACLE_EPS`` on the host, each within
    ``ORACLE_CHAIN20_BOUND``."""
    import numpy as np
    import torch

    from hamilton_tpu_torch import Config, double_pendulum, evolve_ham, native, to_phase
    from hamilton_tpu_torch.mechanics import ham_rhs

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("phase 9: the native engine did not build or load (make -C "
                             "native into hamilton_tpu_torch/_build/native/):\n"
                             + native._build_error)
    log(f"phase 9 (b): native engine {Path(native.load()._name).name} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    dp = double_pendulum(device=dev, dtype=torch.float64)
    ph0 = to_phase(dp.system, Config(torch.tensor([1.0, 0.0], dtype=torch.float64, device=dev),
                                     torch.tensor([0.0, 0.5], dtype=torch.float64, device=dev)))
    y0 = ph0.flatten().cpu().numpy()
    ts = np.asarray(TRIANGLE_TS)
    t0 = time.perf_counter()
    card = evolve_ham(dp.system, ph0, list(TRIANGLE_TS), method="rkf45")
    card = torch.cat([card.q, card.p], -1).cpu().numpy()
    t_card = time.perf_counter() - t0
    rhs = ham_rhs(dp.system)
    t0 = time.perf_counter()
    callback, stats = native.rkf45_evolve_times(
        lambda y: rhs(torch.from_numpy(y.copy()).to(dev)).cpu().numpy(), y0, ts)
    t_callback = time.perf_counter() - t0
    analytic, _ = native.double_pendulum_evolve(1.0, 1.0, y0, ts)
    runs = {"card evolve_ham": card, "native on the card's ham_rhs": callback,
            "native closed form": analytic}
    names = list(runs)
    gaps = {f"{a} vs {b}": float(np.abs(runs[a] - runs[b]).max())
            for i, a in enumerate(names) for b in names[i + 1:]}
    log("phase 9 (b): parity triangle, double pendulum float64 t in [0, 1]: " + ", ".join(
        f"{k} {v:.3e}" for k, v in gaps.items()) + f" (limit {TRIANGLE_TOL:g}); "
        f"{stats['n_steps']} native steps, card evolve_ham {t_card:.2f} s, "
        f"native on the card's RHS {t_callback:.2f} s")
    if not all(np.isfinite(r).all() for r in runs.values()):
        raise AssertionError("phase 9 (b): a parity-triangle run is not finite")
    if not all(v < TRIANGLE_TOL for v in gaps.values()):
        raise AssertionError(f"phase 9 (b): parity triangle gaps {gaps} >= {TRIANGLE_TOL}")
    summary["native_triangle_max_gap"] = max(gaps.values())

    params = ex64.system.params
    masses = params["masses"].cpu().numpy()
    length = float(params["lengths"][0])
    if not bool((params["lengths"] == params["lengths"][0]).all()):
        raise AssertionError("phase 9 (c): the engine's chain takes one link length")
    gravity = float(params["gravity"])
    n = masses.shape[0]
    members = oracle_members(ph64a.q.shape[0])
    q0, p0 = ph64a.q[members].cpu().numpy(), ph64a.p[members].cpu().numpy()
    q1, p1 = out64.q[1][members].cpu().numpy(), out64.p[1][members].cpu().numpy()
    t0 = time.perf_counter()
    member_gaps = []
    for k in range(len(members)):
        nat, _ = native.chain_evolve(masses, np.concatenate([q0[k], p0[k]]), [0.0, 1.0],
                                     link_length=length, gravity=gravity,
                                     eps_abs=ORACLE_EPS, eps_rel=ORACLE_EPS)
        member_gaps.append(max(float(np.abs(q1[k] - nat[1, :n]).max()),
                               float(np.abs(p1[k] - nat[1, n:]).max())))
    log(f"phase 9 (c): phase 8's float64 run ({ph64a.q.shape[0]} x chain-{n}, one shared "
        f"controller, "
        f"t in [0, 1]) against native.chain_evolve at eps {ORACLE_EPS:g} on the host "
        f"({time.perf_counter() - t0:.2f} s), members {members.tolist()}: max |card - "
        f"native| " + ", ".join(f"{g:.3e}" for g in member_gaps)
        + f" (bound {ORACLE_CHAIN20_BOUND:g}, 10x the JAX package's CPU gap)")
    if not all(g < ORACLE_CHAIN20_BOUND for g in member_gaps):
        raise AssertionError(f"phase 9 (c): gaps {member_gaps} >= {ORACLE_CHAIN20_BOUND}")
    summary["native_chain20_max_gap"] = max(member_gaps)


def _launch_name(entry):
    """The name an entry's launches are counted under."""
    from hamilton_tpu_torch import kernels

    return next(name for name, fn in kernels.LAUNCHERS.items() if fn is entry.launch)


def main() -> int:
    import numpy as np
    import torch

    t_main = time.perf_counter()

    def stamp(phase):
        """The seconds into the run at which a phase starts: where the time
        limit goes."""
        log(f"phase {phase} starts {time.perf_counter() - t_main:.1f} s into the run")

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    if not (REPO / "hamilton_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(
            f"chip_smoke: hamilton_tpu_torch/ not found beside {Path(__file__).name}; "
            f"run it from the root of a checkout of the repository"
        )
    sys.path.insert(0, str(REPO))

    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.convert import params_from_numpy
    from hamilton_tpu_torch.ensemble import evolve_ensemble_chunked, evolve_ensemble_final
    from hamilton_tpu_torch.integrators.fixed import make_stepper
    from hamilton_tpu_torch.mechanics import hamiltonian
    from hamilton_tpu_torch.models import chain, double_pendulum
    from hamilton_tpu_torch.ops.fused_step import (
        SUZUKI4_COMPOSITION, coef_table, fused_step_kernel, fused_step_reference,
        fused_stepper,
    )
    from hamilton_tpu_torch.utils import roofline as rl
    from hamilton_tpu_torch.utils.profiling import time_queued

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- build ----------------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    headers = user_family_headers(dev)
    # phase 21 (a)'s kernels compile beside phases 1-20 (one takes minutes)
    late_pool = ThreadPoolExecutor(max_workers=len(CHAIN_CASES))
    late_builds, late_units = phase21_builds(dev, late_pool)
    with ThreadPoolExecutor(max_workers=len(headers)) as pool:
        user_futures = {label: pool.submit(kernels.build_user_family, header)
                        for label, header in headers.items()}
        builds = kernels.build_all(exclude=late_units)
        user_builds = {label: f.result() for label, f in user_futures.items()}
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(builds)} sources and "
        f"{len(user_builds)} generated families at once (generated: " + ", ".join(
            f"{label} {b.seconds:.1f} s" for label, (_, b) in user_builds.items()) + "), "
        f"one nvcc "
        f"a source or part (" + ", ".join(
            f"{name}.cu {b.seconds:.1f} s" + (
                f" in {len(b.paths)} parts: " + " ".join(f"{x:.1f}" for x in b.part_seconds)
                if len(b.paths) > 1 else "") for name, b in builds.items()) + ")")
    ptxas = {}
    for name, pattern, label in (("fused_step", _KERNEL_RE, _k1_label),
                                 ("chain_variants", _VARIANT_RE, _variant_label),
                                 ("family_step", _FAMILY_RE, _family_label),
                                 ("batched_spd", _K2_RE, _k2_label),
                                 ("roofline_probes", _K3_RE, _k3_label)):
        regs = ptxas[name] = ptxas_report(builds[name].log, pattern, label)
        if not regs:
            raise AssertionError(f"nvcc printed no -Xptxas -v report for {name}")
        for kname, nreg, st, ld in regs:
            log(f"ptxas: {kname:<45} {nreg:3d} registers, spill stores {st} B, "
                f"spill loads {ld} B")

    def chain20(dtype):
        return chain(n_links=20, fused_solver="semiseparable", device=dev, dtype=dtype)

    def dpend(dtype):
        return double_pendulum(device=dev, dtype=dtype)

    # (label, example factory, iters, compensated, dt, jitter seed)
    configs = [
        ("chain-20 semiseparable (2,0) kahan", chain20, (2, 0), True, 5e-4, 0),
        ("double pendulum dense (2,1)", dpend, (2, 1), False, 1e-3, 1),
    ]
    # the semiseparable rows (chain-20, TOL's chain, and chain-5: the
    # headline's shared table, the sweep's per-member tables, order 4's
    # composition), each dtype, at 1000 members and at the ragged batches,
    # over the 50 steps TOL was read at: (n, swept, composition, batch)
    semisep_cases = [(n, swept, comp, batch) for n in (20, 5)
                     for batch in (1000,) + RAGGED_BATCHES
                     for swept in (False, True) for comp in ((1.0,), SUZUKI4_COMPOSITION)
                     if (n, swept, comp, batch) != (20, False, (1.0,), 1000)]

    # ---- phase 1: kernel against plain version ---------------------------
    checks = start_gauss4_checks()
    stamp(1)
    phase1_failures = []

    def phase1(label, forms, state, dt, kw, dname, batch, spc, tol=None):
        k_out = fused_step_kernel(forms, state, dt, steps_per_call=spc, **kw)
        p_out = fused_step_reference(forms, state, dt, steps_per_call=spc, **kw)
        torch.cuda.synchronize()
        _, errs, failures = compare_states(k_out, p_out, dname, tol)
        phase1_failures.extend(f"{label} {dname} B={batch}: {f}" for f in failures)
        log(f"phase 1 {'FAILED' if failures else 'ok'}: {label} {dname} "
            f"B={batch} spc={spc}: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))

    for label, make, iters, comp, dt, seed in configs:
        for dtype in (torch.float64, torch.float32):
            ex = make(dtype)
            forms = ex.system.fused_forms(ex.system)
            st = fused_stepper(forms, iters=iters, compensated=comp, steps_per_call=50)
            state = st.init(jittered_phase(ex, 1000, dtype, dev, seed))
            phase1(label, forms, state, dt, dict(iters=iters, compensated=comp),
                   str(dtype).split(".")[-1], 1000, 50)
    t_semisep = time.perf_counter()
    phase1_failures.extend(phase1_semiseparable(dev, semisep_cases))
    log(f"phase 1: the semiseparable rows took {time.perf_counter() - t_semisep:.1f} s")
    t_dense = time.perf_counter()
    phase1_failures.extend(phase1_dense(dev))
    log(f"phase 1: the one-thread dense rows took {time.perf_counter() - t_dense:.1f} s")
    # the K1 and K2 kernels' float sin/cos, sqrt and reciprocal (straight-line,
    # and the library's that take over outside their ranges: the chain's,
    # the families' and the generated forms, the batched factor and solve)
    # against sinf, cosf, sqrtf and 1/x on every float in each one's range
    # (csrc/libm_check.cu)
    t_check = time.perf_counter()
    mismatches = kernels.libm_mismatches()
    log(f"phase 1 {'ok' if not any(mismatches.values()) else 'FAILED'}: the kernels' "
        f"float sin/cos, sqrt and reciprocal vs sinf/cosf, sqrtf and 1/x on every float in "
        f"their ranges: {mismatches} differ ({time.perf_counter() - t_check:.2f} s)")
    if any(mismatches.values()):
        phase1_failures.append(f"the kernels' float functions differ from sinf/cosf, "
                               f"sqrtf or 1/x: {mismatches}")
    # the semiseparable kernels' layout as built, registers and spills
    by_name = {name: (r, st, ld) for name, r, st, ld in ptxas["fused_step"]}
    for n in (20, 5):
        for dtype_code, tname in ((0, "float"), (1, "double")):
            for swept in (False, True):
                lanes, block, smem, blocks = kernels.lane_layout("fused_step", dtype_code, n,
                                                                 per_member=swept)
                label = f"{tname} n={n} semiseparable kahan{' per-member' if swept else ''}"
                r, st, ld = by_name[label]
                plural = "s" if lanes > 1 else ""
                log(f"phase 1: {label}: {lanes} lane{plural} a member, {block} threads and "
                    f"{smem} B of shared memory a block, {blocks} blocks "
                    f"({blocks * block // 32} warps) an SM, {r} registers, spill stores {st} B, "
                    f"spill loads {ld} B")
    # the one-thread dense parts' layout as built, registers and spills
    for source, code, form in (("fused_step", 2, "n=2 dense"),
                               ("chain_variants", 4, "dense n=4")):
        for dtype_code, tname in ((0, "float"), (1, "double")):
            layout = {kernels.lane_layout(source, dtype_code, code, compensated=comp,
                                          per_member=swept, semiseparable=False)
                      for comp in (False, True) for swept in (False, True)}
            rows = [(r, st, ld) for name, r, st, ld in ptxas[source]
                    if name.startswith(f"{tname} {form}")]
            log(f"phase 1: {source}.cu {tname} {form}: (lanes, threads a block, dynamic shared "
                f"B, blocks an SM) {sorted(layout)}; {len(rows)} instantiations, "
                f"{min(r for r, _, _ in rows)}-{max(r for r, _, _ in rows)} registers, "
                f"spill stores {max(st for _, st, _ in rows)} B, spill loads "
                f"{max(ld for _, _, ld in rows)} B at most")
    if phase1_failures:
        raise AssertionError("kernel disagrees with its plain version: "
                             + "; ".join(phase1_failures))
    # phase 21 (a)'s checks time nothing: they run beside phase 19's
    t_chain = time.perf_counter()
    chain_checked = phase_chain_checks(dev, late_builds)
    log(f"phase 1: phase 21 (a)'s checks took {time.perf_counter() - t_chain:.1f} s")
    t_wait = time.perf_counter()
    checks = collect_gauss4_checks(checks)
    log(f"phase 1: waited {time.perf_counter() - t_wait:.1f} s for phase 19's checks")

    # ---- phase 2: kernel against physics --------------------------------
    stamp(2)
    ex5 = chain(n_links=5, fused_solver="semiseparable", device=dev, dtype=torch.float64)
    ph5 = jittered_phase(ex5, 1000, torch.float64, dev, 2)
    ph5 = type(ph5)(ph5.q, ph5.p + 0.01)
    lib = make_stepper(ex5.system, "leapfrog", iters=(3, 2))
    fus = make_stepper(ex5.system, "leapfrog_fused", iters=(3, 2))
    dt5 = torch.tensor(1e-3, dtype=torch.float64)
    c_lib, c_fus = lib.init(ph5), fus.init(ph5)
    for _ in range(2):
        c_lib, c_fus = lib.step(c_lib, dt5), fus.step(c_fus, dt5)
    a, b = lib.extract(c_lib), fus.extract(c_fus)
    err_phys = max(float((a.q - b.q).abs().max()), float((a.p - b.p).abs().max()))
    if not err_phys <= PHYSICS_TOL:
        raise AssertionError(f"fused kernel vs library leapfrog: {err_phys:.3e} > {PHYSICS_TOL}")
    log(f"phase 2 ok: chain-5 float64 (3,2) kernel vs library leapfrog, 2 steps: "
        f"{err_phys:.2e}")

    # ---- phase 3: the headline ---------------------------------------------
    stamp(3)
    spc, chunk, n_steps = 50, 10_000, HEADLINE_STEPS
    ex20 = chain20(torch.float32)
    ph = jittered_phase(ex20, BATCH, torch.float32, dev, 0)
    marks = []

    def on_chunk(ci, phase, drift):
        marks.append(time.perf_counter())

    def headline(compensated, callback=None):
        return evolve_ensemble_chunked(
            ex20.system, ph, 5e-4, n_steps, chunk_steps=chunk,
            method="leapfrog_fused", iters=(2, 0), compensated=compensated,
            drift_every=1000, drift_dtype=torch.float64, callback=callback,
            steps_per_call=spc,
        )

    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    final, drift = headline(True, on_chunk)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    head_launches, head_k2a = counts["fused_step"], counts["spd_solve"]
    if head_launches != n_steps // spc:
        raise AssertionError(f"headline made {head_launches} kernel launches, "
                             f"expected {n_steps // spc}")
    # the sampler: H₀ and one float64 K2a solve per sample
    expect_samples = {**{k: 0 for k in counts}, "fused_step": n_steps // spc,
                      "spd_solve": 1 + n_steps // 1000}
    if counts != expect_samples:
        raise AssertionError(f"headline launch counts {counts}, expected {expect_samples}")
    if not (bool(torch.isfinite(final.q).all()) and bool(torch.isfinite(final.p).all())
            and bool(torch.isfinite(drift).all())):
        raise AssertionError("headline output is not finite")
    if tuple(final.q.shape) != (BATCH, 20):
        raise AssertionError(f"headline output shape {tuple(final.q.shape)}")
    max_drift = float(drift.max())
    head_rate, head_first, head_chunks = steady_rate(marks, t0, BATCH, chunk)
    log(f"phase 3: headline 16384 x chain-20 float32 (2,0) kahan dt=5e-4, "
        f"{n_steps} steps: {head_rate:.6e} member-steps/s over {head_chunks} "
        f"steady chunks (first chunk {head_first:.3f} s), "
        f"max|dH/H0| {max_drift:.6e}, launches {counts}")
    if not max_drift < DRIFT_BOUND:
        raise AssertionError(f"headline drift {max_drift:.3e} >= {DRIFT_BOUND}")

    # ---- phase 4: the double pendulum --------------------------------------
    stamp(4)
    exdp = dpend(torch.float32)
    phdp = jittered_phase(exdp, BATCH, torch.float32, dev, 1)

    def dp_run(n):
        return evolve_ensemble_final(
            exdp.system, phdp, 1e-3, n, method="leapfrog_fused", iters=(2, 1),
            track_drift=False, drift_every=n, steps_per_call=spc,
        )[0]

    dp_run(spc)  # first launch outside the timing
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(DP_REPEATS):
        dp_final = dp_run(DP_STEPS)
    torch.cuda.synchronize()
    dp_el = time.perf_counter() - t0
    dp_launches = kernels.fused_step_launch.launches
    if dp_launches != DP_REPEATS * DP_STEPS // spc:
        raise AssertionError(f"double pendulum made {dp_launches} launches, "
                             f"expected {DP_REPEATS * DP_STEPS // spc}")
    if not (bool(torch.isfinite(dp_final.q).all()) and bool(torch.isfinite(dp_final.p).all())):
        raise AssertionError("double-pendulum output is not finite")
    dp_rate = BATCH * DP_STEPS * DP_REPEATS / dp_el
    log(f"phase 4: double pendulum 16384 float32 (2,1) dt=1e-3, {DP_REPEATS} x "
        f"{DP_STEPS} steps in {dp_el * 1e3:.2f} ms: {dp_rate:.6e} member-steps/s "
        f"({dp_launches} launches, {dp_el / dp_launches * 1e6:.2f} us of wall each)")

    # ---- phase 5: plain version's time beside the kernel's -----------------
    stamp(5)
    entries = []
    issue_us = {}  # name → (host us to issue a launch, card us a launch)
    shapes = [
        ("fused_step semiseparable n=20 float32 kahan (2,0)", ex20, ph, (2, 0), True,
         5e-4, head_launches),
        ("fused_step dense n=2 float32 (2,1)", exdp, phdp, (2, 1), False, 1e-3,
         dp_launches),
    ]
    for name, ex, ph0, iters, comp, dt, launches in shapes:
        forms = ex.system.fused_forms(ex.system)
        st = fused_stepper(forms, iters=iters, compensated=comp, steps_per_call=spc)
        state = st.init(ph0)
        coef = coef_table(forms, state.device, state.dtype)

        def kern():
            return fused_step_kernel(forms, state, dt, iters=iters, compensated=comp,
                                     steps_per_call=spc, coef=coef)

        def plain():
            return fused_step_reference(forms, state, dt, iters=iters, compensated=comp,
                                        steps_per_call=spc)

        k_out = kern()  # warm-up
        # in turns on one card: plain, kernel, kernel, plain
        p1, p_out = time_call(plain, 1)
        k1, h1 = time_queued(kern, 100)
        k2, h2 = time_queued(kern, 100)
        p2, _ = time_call(plain, 1)
        worst, errs, failures = compare_states(k_out, p_out, "float32")
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        log(f"phase 5: {name} B={ph0.q.shape[0]} spc={spc}: kernel {ms:.4f} ms "
            f"on the card ({k1:.4f}, {k2:.4f}), host {(h1 + h2) / 2 * 1e3:.2f} us "
            f"to issue one ({h1 * 1e3:.2f}, {h2 * 1e3:.2f}), plain {plain_ms:.2f} ms "
            f"({p1:.2f}, {p2:.2f}), " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        if failures:
            raise AssertionError(f"{name}: kernel disagrees with its plain version: "
                                 + "; ".join(failures))
        bound_ms, bound_by, _ = k1_bound(ex.system, "leapfrog_fused", iters, comp,
                                         ph0.q.shape[0], spc)
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        issue_us[name] = ((h1 + h2) / 2 * 1e3, ms * 1e3)
    # the double pendulum's launch: phase 4's wall against the card's time
    # and the host's issue, the larger of which sets its pace
    dp_issue, dp_card = issue_us["fused_step dense n=2 float32 (2,1)"]
    dp_wall = dp_el / dp_launches * 1e6
    log(f"phase 5: the double pendulum a launch: {dp_wall:.2f} us of wall (phase 4), the card "
        f"{dp_card:.2f} us, the host {dp_issue:.2f} us to issue it: "
        f"{'host' if dp_issue > dp_card else 'card'}-bound")

    # the drift sampler's share of the headline: one float64 library
    # Hamiltonian of the 16384 x chain-20 state, as evolve_ensemble_chunked takes it
    sys64 = ex20.system.to(dtype=torch.float64)
    ph64 = final.astype(torch.float64)
    hamiltonian(sys64, ph64)
    h_ms, _ = time_call(lambda: hamiltonian(sys64, ph64), 5)
    log(f"phase 5: drift sample (float64 hamiltonian, 16384 x chain-20, K2a solve): "
        f"{h_ms:.3f} ms; {n_steps // 1000} samples in the headline")

    # ---- phase 6: control without compensation ------------------------------
    stamp(6)
    ctl_final, ctl_drift = headline(False)
    ctl_max = float(ctl_drift.max())
    if not (bool(torch.isfinite(ctl_final.q).all()) and math.isfinite(ctl_max)):
        raise AssertionError("control output is not finite")
    log(f"phase 6: control, headline without Kahan: max|dH/H0| {ctl_max:.6e} "
        f"(bound {DRIFT_BOUND:.0e}, compensated {max_drift:.6e})")
    if not ctl_max > DRIFT_BOUND:
        raise AssertionError(
            f"the uncompensated control drifts {ctl_max:.3e}, under the bound "
            f"{DRIFT_BOUND}: the headline's drift check cannot see a lost compensation"
        )

    # ---- phase 7: the K2 kernels against their plain versions ---------------
    stamp(7)
    from hamilton_tpu_torch.ops.batched_spd import ENTRIES

    k2_rows = {(name, n): {"m": m, "dtype": dname} for name, n, m, dname in K2_ROWS}
    errs = {e.name: 0.0 for e in ENTRIES}
    for batch in K2_BATCHES:
        for n in K2_SIZES:
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).split(".")[-1]
                k, js, b = k2_inputs(batch, n, dtype, dev, 1000 * n + batch)
                js_n = k2_inputs(batch, n, dtype, dev, 1000 * n + batch, m=n)[1]
                row = []
                # the J entries at m = 2n and at m = n (spring's shape)
                for e, m in [(e, m) for e in ENTRIES
                             for m in ((2 * n, n) if e.from_jac else (0,))]:
                    args = k2_args(e, k, js_n if m == n else js, b)
                    got, want = e.kernel(*args), e.plain(*args)
                    torch.cuda.synchronize()
                    if not all_finite(got, want):
                        raise AssertionError(f"{e.name} B={batch} n={n} m={m} {dname}: "
                                             f"not finite")
                    err = float((got - want).abs().max())
                    errs[e.name] = max(errs[e.name], err)
                    row.append(f"{e.name}{f' m={m}' if m else ''} {err:.1e}")
                    if not err <= K2_TOL:
                        raise AssertionError(f"{e.name} B={batch} n={n} m={m} {dname}: kernel "
                                             f"differs from its plain version by {err:.3e}")
                log(f"phase 7 ok: B={batch} n={n} {dname}: " + ", ".join(row))
    for (name, _), r in k2_rows.items():
        r["max_abs_err"] = errs[name]
    # one PyTorch call computing each entry's function on its operands, the
    # yardstick beside the kernel (the port never calls these), timed as the
    # kernels are where it can be queued (the _ex forms: linalg.cholesky and
    # linalg.solve check their info on the host); K2d and K2e have none
    # (forming K is a second call)
    k2_library = {
        "spd_solve_batched": lambda k, b: torch.linalg.solve_ex(k, b, check_errors=False)[0],
        "cholesky_batched": lambda k: torch.linalg.cholesky_ex(k, check_errors=False)[0],
        "cho_solve_batched": lambda low, b: torch.cholesky_solve(b[..., None], low),
    }
    by_name = {e.name: e for e in ENTRIES}
    k2_f32_ms = {}
    # every entry at 16384 x 20 (the J entries at m = 40) in both dtypes,
    # then the kernels line's rows at other shapes
    timed = [(e.name, 20, 40 if e.from_jac else 0, dname)
             for dname in ("float32", "float64") for e in ENTRIES]
    timed += [row for row in K2_ROWS if row not in timed]
    inputs = {}
    for name, n, m, dname in timed:
        e, dtype = by_name[name], getattr(torch, dname)
        if (n, m or 2 * n, dname) not in inputs:
            inputs[(n, m or 2 * n, dname)] = [k2_inputs(BATCH, n, dtype, dev, 7 + s, m=m or None)
                                              for s in range(K2_ROTATE)]
        rotating = [k2_args(e, *x) for x in inputs[(n, m or 2 * n, dname)]]
        args = rotating[0]
        e.kernel(*args)
        e.plain(*args)  # warm-up
        # in turns on one card: plain, kernel, kernel, plain
        p1, _ = time_call(lambda: e.plain(*args), 2)
        k1, _ = time_queued(lambda: e.kernel(*args), 100)
        k2, _ = time_queued(lambda: e.kernel(*args), 100)
        p2, _ = time_call(lambda: e.plain(*args), 2)
        turn = iter(range(10**9))
        rot, _ = time_queued(lambda: e.kernel(*rotating[next(turn) % K2_ROTATE]), 100)
        lib_ms = None
        if e.name in k2_library:
            lib = k2_library[e.name]
            lib(*args)  # warm-up
            # queued as the kernels are, unless the call reads back to the
            # host itself: then CUDA events around calls back to back
            synced = reads_back(lambda: lib(*args))
            timer = time_call if synced else time_queued
            l1, _ = timer(lambda: lib(*args), 20)
            l2, _ = timer(lambda: lib(*args), 20)
            lib_ms = (l1 + l2) / 2
        log(f"phase 7: {e.name} 16384 x n={n}{f' m={m}' if m else ''} {dname}: kernel "
            f"{(k1 + k2) / 2:.4f} ms "
            f"({k1:.4f}, {k2:.4f}; on {K2_ROTATE} operand sets in turn {rot:.4f}), plain "
            f"{(p1 + p2) / 2:.3f} ms ({p1:.3f}, {p2:.3f})"
            + ("" if lib_ms is None else f", one PyTorch call {lib_ms:.4f} ms "
               f"({l1:.4f}, {l2:.4f}; "
               f"{'it reads back to the host' if synced else 'queued'})"))
        r = k2_rows.get((e.name, n))
        if r and (r["m"], r["dtype"]) == (m, dname):
            r.update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=lib_ms)
        if dname == "float32":
            k2_f32_ms[(e.name, n, m)] = (k1 + k2) / 2
    del inputs, rotating, args
    phase_k2_bfloat16(dev, by_name, k2_library, k2_f32_ms, entries)

    # ---- phase 8: adaptive GSL-RKF45 at full width --------------------------
    stamp(8)
    from hamilton_tpu_torch import Config, Phase, evolve_ham, spring, to_phase
    from hamilton_tpu_torch.integrators import adaptive

    summary = {}
    for dtype, eps in ((torch.float64, GSL_EPS), (torch.float32, ADAPTIVE_F32_EPS)):
        dname = str(dtype).split(".")[-1]
        exa = chain(n_links=20, device=dev, dtype=dtype)
        pha = jittered_phase(exa, BATCH, dtype, dev, ADAPTIVE_SEED)
        adaptive.gsl_evolve_to.host_reads = 0
        t0 = time.perf_counter()
        (out, st), counts = counted(lambda: evolve_ham(
            exa.system, pha, [0.0, 1.0], eps_abs=eps, eps_rel=eps, return_stats=True))
        el = time.perf_counter() - t0
        stats = {k: int(v) for k, v in st.items()}
        attempts = adaptive.gsl_evolve_to.host_reads - 1
        if stats["saturated"] or attempts != stats["max_interval_steps"]:
            raise AssertionError(f"adaptive {dname}: stats {stats}, {attempts} attempts")
        expect_counts(f"adaptive {dname}", counts, spd_solve=6 * attempts)
        if not all_finite(out.q, out.p) or tuple(out.q.shape) != (2, BATCH, 20):
            raise AssertionError(f"adaptive {dname}: output not finite or shaped "
                                 f"{tuple(out.q.shape)}")
        drift_a = rel_drift(exa.system, Phase(out.q[0], out.p[0]), Phase(out.q[1], out.p[1]))
        log(f"phase 8: adaptive rkf45 16384 x chain-20 {dname} eps={eps:g} t in [0, 1]: "
            f"{el:.3f} s, {BATCH / el:.6e} trajectories/s, {attempts} attempts "
            f"({stats['total_failed']} rejected), saturated {bool(stats['saturated'])}, "
            f"{counts['spd_solve']} K2a launches, {attempts + 1} host reads, "
            f"max|dH/H0| at t=1 {drift_a:.6e}")
        summary[f"adaptive_{dname}_traj_per_sec"] = BATCH / el
        summary[f"adaptive_{dname}_max_drift"] = drift_a
        if dtype == torch.float64:
            # and the headline's float64 drift sampler, at the same shape
            k2_rows[("spd_solve_batched", 20)]["launches"] = counts["spd_solve"] + head_k2a
            if not drift_a < ADAPTIVE_DRIFT_BOUND:
                raise AssertionError(f"adaptive float64 drift {drift_a:.3e} >= "
                                     f"{ADAPTIVE_DRIFT_BOUND}")
            ex64, ph64a, out64 = exa, pha, out

    # ---- phase 9: the adaptive path on the card against the CPU -------------
    stamp(9)
    ex_cpu = chain(n_links=20, device="cpu", dtype=torch.float64)
    ph8 = Phase(ph64a.q[:8], ph64a.p[:8])
    for mode in ("shared", "per_member"):
        card_out, card_st = evolve_ham(ex64.system, ph8, [0.0, 1.0], batch_mode=mode,
                                       return_stats=True)
        cpu_out, cpu_st = evolve_ham(ex_cpu.system, Phase(ph8.q.cpu(), ph8.p.cpu()),
                                     [0.0, 1.0], batch_mode=mode, return_stats=True)
        err = max(float((card_out.q.cpu() - cpu_out.q).abs().max()),
                  float((card_out.p.cpu() - cpu_out.p).abs().max()))
        card_st = {k: int(v) for k, v in card_st.items()}
        cpu_st = {k: int(v) for k, v in cpu_st.items()}
        log(f"phase 9: adaptive chain-20 float64 8 members {mode}: card vs CPU {err:.3e} "
            f"(|p| up to {float(cpu_out.p.abs().max()):.2f}), stats card {card_st} "
            f"CPU {cpu_st}")
        if not err <= CPU_TOL_F64 or card_st != cpu_st:
            raise AssertionError(f"adaptive {mode}: card and CPU differ by {err:.3e} "
                                 f"(limit {CPU_TOL_F64}) or in their steps")
    phase_native_oracle(dev, ex64, ph64a, out64, summary)

    # ---- phase 10: the library leapfrog at full width -----------------------
    stamp(10)
    t0 = time.perf_counter()
    (lf_final, lf_drift), counts = counted(lambda: evolve_ensemble_final(
        ex20.system, ph, 5e-4, LEAPFROG_STEPS, method="leapfrog", iters=(2, 0),
        compensated=True, drift_every=1000, drift_dtype=torch.float64))
    el = time.perf_counter() - t0
    expect_counts("library leapfrog", counts, cholesky=LEAPFROG_STEPS + 1,
                  cho_solve=5 * LEAPFROG_STEPS, spd_solve=1 + LEAPFROG_STEPS // 1000)
    if not all_finite(lf_final.q, lf_final.p, lf_drift):
        raise AssertionError("library leapfrog output is not finite")
    lf_rate = BATCH * LEAPFROG_STEPS / el
    log(f"phase 10: library leapfrog 16384 x chain-20 float32 (2,0) kahan dt=5e-4, "
        f"{LEAPFROG_STEPS} steps in {el:.3f} s: {lf_rate:.6e} member-steps/s, "
        f"max|dH/H0| {float(lf_drift.max()):.6e}, launches {counts}")
    summary["library_leapfrog_member_steps_per_sec"] = lf_rate
    summary["library_leapfrog_max_drift"] = float(lf_drift.max())
    # the card's busy share over BUSY_STEPS more steps: the kernels' device
    # time (torch.profiler) over the wall time of the run
    busy_s, busy_wall = busy_time(lambda: evolve_ensemble_final(
        ex20.system, ph, 5e-4, BUSY_STEPS, method="leapfrog", iters=(2, 0), compensated=True,
        track_drift=False, drift_every=BUSY_STEPS))
    log(f"phase 10: library leapfrog, {BUSY_STEPS} steps under torch.profiler: the card busy "
        f"{busy_s * 1e3:.3f} ms of {busy_wall * 1e3:.3f} ms wall, "
        f"{100 * busy_s / busy_wall:.2f} %")
    summary["library_leapfrog_device_busy_share"] = busy_s / busy_wall
    k2_rows[("cholesky_batched", 20)]["launches"] = counts["cholesky"]
    k2_rows[("cho_solve_batched", 20)]["launches"] = counts["cho_solve"]

    # ---- phase 11: the J route at full width --------------------------------
    stamp(11)
    sys_j = generic_chain(20, dev, torch.float32)
    t0 = time.perf_counter()
    (j_final, j_drift), counts = counted(lambda: evolve_ensemble_final(
        sys_j, ph, 5e-4, J_STEPS, method="leapfrog", iters=(2, 0), compensated=True,
        drift_every=100, drift_dtype=torch.float64))
    el = time.perf_counter() - t0
    expect_counts("J-route leapfrog", counts, cholesky_jac=J_STEPS + 1,
                  cho_solve=5 * J_STEPS, spd_solve_jac=1 + J_STEPS // 100)
    if not all_finite(j_final.q, j_final.p, j_drift):
        raise AssertionError("J-route leapfrog output is not finite")
    j_rate = BATCH * J_STEPS / el
    log(f"phase 11: J-route leapfrog 16384 x chain-20 from its coordinate map, float32 "
        f"(2,0) kahan dt=5e-4, {J_STEPS} steps in {el:.3f} s: {j_rate:.6e} "
        f"member-steps/s, max|dH/H0| {float(j_drift.max()):.6e}, launches {counts}")
    summary["j_route_leapfrog_member_steps_per_sec"] = j_rate
    busy_s, busy_wall = busy_time(lambda: evolve_ensemble_final(
        sys_j, ph, 5e-4, BUSY_STEPS, method="leapfrog", iters=(2, 0), compensated=True,
        track_drift=False, drift_every=BUSY_STEPS))
    log(f"phase 11: J-route leapfrog, {BUSY_STEPS} steps under torch.profiler: the card busy "
        f"{busy_s * 1e3:.3f} ms of {busy_wall * 1e3:.3f} ms wall, "
        f"{100 * busy_s / busy_wall:.2f} %")
    summary["j_route_leapfrog_device_busy_share"] = busy_s / busy_wall
    k2_rows[("cholesky_jac", 20)]["launches"] = counts["cholesky_jac"]
    k2_rows[("spd_solve_jac", 20)]["launches"] = counts["spd_solve_jac"]
    sl = Phase(ph.q[:1000], ph.p[:1000])
    run = dict(method="leapfrog", iters=(2, 0), compensated=True, track_drift=False,
               drift_every=20)
    j_card, _ = evolve_ensemble_final(sys_j, sl, 5e-4, 20, **run)
    j_cpu, _ = evolve_ensemble_final(generic_chain(20, "cpu", torch.float32),
                                     Phase(sl.q.cpu(), sl.p.cpu()), 5e-4, 20, **run)
    err = max(float((j_card.q.cpu() - j_cpu.q).abs().max()),
              float((j_card.p.cpu() - j_cpu.p).abs().max()))
    log(f"phase 11: J-route leapfrog, 1000 members x 20 steps, card vs CPU: {err:.3e}")
    if not err <= CPU_TOL_F32:
        raise AssertionError(f"J-route leapfrog: card and CPU differ by {err:.3e}")

    sp = spring(device=dev, dtype=torch.float64)
    rng = np.random.default_rng(3)
    q_sp = sp.init_config.q.cpu().numpy() + 0.01 * rng.standard_normal((BATCH, 3))
    ph_sp = to_phase(sp.system, Config(torch.tensor(q_sp, device=dev),
                                       sp.init_config.v.expand(BATCH, 3)))
    ts = torch.linspace(0.0, 1.0, 11, dtype=torch.float64)
    adaptive.gsl_evolve_to.host_reads = 0
    t0 = time.perf_counter()
    (sp_out, st), counts = counted(lambda: evolve_ham(sp.system, ph_sp, ts, return_stats=True))
    el = time.perf_counter() - t0
    attempts = adaptive.gsl_evolve_to.host_reads - (len(ts) - 1)
    stats = {k: int(v) for k, v in st.items()}
    expect_counts("spring evolve_ham", counts, spd_solve_jac=6 * attempts)
    if stats["saturated"] or not all_finite(sp_out.q, sp_out.p):
        raise AssertionError(f"spring evolve_ham: stats {stats}, or output not finite")
    log(f"phase 11: spring evolve_ham 16384 float64 over 10 intervals: {el:.3f} s, "
        f"{BATCH / el:.6e} trajectories/s, {attempts} attempts ({stats['total_failed']} "
        f"rejected), {counts['spd_solve_jac']} K2d launches, max|dH/H0| at t=1 "
        f"{rel_drift(sp.system, Phase(sp_out.q[0], sp_out.p[0]), Phase(sp_out.q[-1], sp_out.p[-1])):.6e}")
    k2_rows[("spd_solve_jac", 3)]["launches"] = counts["spd_solve_jac"]
    sp_card = evolve_ham(sp.system, Phase(ph_sp.q[:1000], ph_sp.p[:1000]), ts)
    sp_cpu = evolve_ham(spring(device="cpu", dtype=torch.float64).system,
                        Phase(ph_sp.q[:1000].cpu(), ph_sp.p[:1000].cpu()), ts)
    err = max(float((sp_card.q.cpu() - sp_cpu.q).abs().max()),
              float((sp_card.p.cpu() - sp_cpu.p).abs().max()))
    log(f"phase 11: spring evolve_ham, 1000 members, card vs CPU: {err:.3e}")
    if not err <= CPU_TOL_F64:
        raise AssertionError(f"spring evolve_ham: card and CPU differ by {err:.3e}")

    for (name, n), r in k2_rows.items():
        e, m = by_name[name], r["m"]
        if not r.get("launches"):
            raise AssertionError(f"{name} n={n}: its main path launched it no time")
        dtype = getattr(torch, r["dtype"])
        ops, nbytes = k2_work(e, BATCH, n, m, dtype)
        bound_ms, bound_by = rl.bound(ops, nbytes, dtype)
        entries.append({
            "name": f"{name} n={n}{f' m={m}' if m else ''} {r['dtype']}",
            "route": "cuda", "source": K2_SOURCE,
            "replaces": e.replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": r["library_ms"],
        })

    # ---- phase 12: the roofline path -----------------------------------------
    stamp(12)
    # every layout the sweep below can pick, against the plain version on
    # small random inputs (so a misplaced element shows)
    g = torch.Generator().manual_seed(12)
    x_fma = (1.0 + torch.rand(16 * 16 * 1024, generator=g)).to(dev)
    x_sin = torch.rand(16 * 16 * 1024, generator=g).to(dev)
    a_small = torch.randn(1 << 22, generator=g).to(dev)
    k3_want = {"fma_probe": rl.fma_chain_plain(x_fma, 256),
               "sin_probe": rl.sin_chain_plain(x_sin, 64), "add_one": rl.add_one_plain(a_small)}
    k3_err = {name: 0.0 for name in k3_want}

    def check_probe(name, got, want, what):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (all_finite(got, want) and err <= K3_TOL[name]):
            raise AssertionError(f"{name} kernel disagrees with its plain version ({what}): "
                                 f"{err:.3e} > {K3_TOL[name]:.0e}")
        k3_err[name] = max(k3_err[name], err)

    for ilp in PROBE_ILP:
        for blk in PROBE_BLOCKS:
            what = f"chains {ilp}, block {blk}"
            check_probe("fma_probe", rl.fma_chain(x_fma, 256, chains=ilp, block=blk),
                        k3_want["fma_probe"], what)
            check_probe("sin_probe", rl.sin_chain(x_sin, 64, chains=ilp, block=blk),
                        k3_want["sin_probe"], what)
    for blk in HBM_BLOCKS:
        check_probe("add_one", rl.add_one(a_small, blocks=blk), k3_want["add_one"],
                    f"{blk} blocks")
    log(f"phase 12 ok: probe kernels vs plain at every layout of the sweep ("
        f"{len(PROBE_ILP) * len(PROBE_BLOCKS)} for K3a/K3b on {x_fma.numel()} elements, "
        f"{len(HBM_BLOCKS)} for K3c on {a_small.numel()}): "
        + ", ".join(f"{k} {v:.3e} (limit {K3_TOL[k]:.0e})" for k, v in k3_err.items()))
    del k3_want, a_small

    def probe_sweep():
        fma = {(ilp, blk): rl.vpu_peak_probe(ilp=ilp, block=blk, device=dev)
               for ilp in PROBE_ILP for blk in PROBE_BLOCKS}
        sin = {(ilp, blk): rl.vpu_trig_probe(ilp=ilp, block=blk, device=dev)
               for ilp in PROBE_ILP for blk in PROBE_BLOCKS}
        hbm = {blk: rl.hbm_peak_probe(blocks=blk, device=dev) for blk in HBM_BLOCKS}
        return fma, sin, hbm

    (fma, sin, hbm), counts = counted(probe_sweep)
    # each probe: 3 (4 for K3c) launches in the first run, then 5 timed runs
    n_chain = len(PROBE_ILP) * len(PROBE_BLOCKS) * 6 * 3
    expect_counts("roofline probes", counts, fma_probe=n_chain, sin_probe=n_chain,
                  add_one=len(HBM_BLOCKS) * 6 * 4)
    for label, rates, unit, keys in (
        ("fma", fma, "FLOP/s", "chains per thread, block"),
        ("sin", sin, "sin/s", "chains per thread, block"),
        ("hbm", hbm, "B/s", "blocks of 256 threads"),
    ):
        log(f"phase 12: {label} probe sweep ({keys}): "
            + ", ".join(f"{k}: {v:.6e}" for k, v in rates.items()) + f" {unit}")
    best_fma = max(fma, key=fma.get)
    best_sin = max(sin, key=sin.get)
    best_hbm = max(hbm, key=hbm.get)
    fma_peak, sin_peak, hbm_peak = fma[best_fma], sin[best_sin], hbm[best_hbm]
    # nothing folded: half the repetitions take half the time (same rate)
    fma_half = rl.vpu_peak_probe(reps=8192, ilp=best_fma[0], block=best_fma[1], device=dev)
    sin_half = rl.vpu_trig_probe(reps=512, ilp=best_sin[0], block=best_sin[1], device=dev)
    # K3b's bound: a sine's work on its slowest pipe at the published peak's clock
    sin_bound_rate = rl.PEAK_FLOPS[torch.float32] / rl.SIN_FLOPS
    log(f"phase 12: ceilings on {card}: float32 FMA {fma_peak:.6e} FLOP/s "
        f"({fma_peak / rl.PEAK_FLOPS[torch.float32]:.4f} of the published 67 TFLOP/s; "
        f"chains {best_fma[0]}, block {best_fma[1]}), "
        f"straight-line sin/s {sin_peak:.6e} (chains {best_sin[0]}, block {best_sin[1]}; "
        f"{fma_peak / sin_peak:.2f} flops per sin; {sin_peak / sin_bound_rate:.4f} of its "
        f"bound {sin_bound_rate:.6e} sin/s, a sine's 2 conversions at 16 a clock an SM "
        f"at the published peak's clock), "
        f"device memory {hbm_peak:.6e} B/s ({hbm_peak / rl.PEAK_BYTES_PER_S:.4f} of the "
        f"published 3.35 TB/s; {best_hbm} blocks); at half the reps the rates are "
        f"{fma_half / fma_peak:.4f} (FMA) and {sin_half / sin_peak:.4f} (sin) of these")
    for what, ratio in (("FMA", fma_half / fma_peak), ("sin", sin_half / sin_peak)):
        if not 0.85 <= ratio <= 1.15:
            raise AssertionError(f"the {what} probe's time does not grow with its "
                                 f"repetitions (rate ratio {ratio:.3f}): folded?")
    if not (fma_peak <= 1.05 * rl.PEAK_FLOPS[torch.float32]
            and hbm_peak <= 1.05 * rl.PEAK_BYTES_PER_S):
        raise AssertionError("a ceiling exceeds the published peak by more than 5 %")
    head_cost = rl.fused_step_cost(ex20.system, iters=(2, 0), steps_per_call=spc,
                                   compensated=True, batch=BATCH)
    head_flops = head_rate * head_cost["flops_per_member_step"]
    head_sins = head_rate * head_cost["transcendentals_per_member_step"]
    log(f"phase 12: headline fused_step_cost: {head_cost}; at {head_rate:.6e} "
        f"member-steps/s: {head_flops:.6e} FLOP/s = {head_flops / fma_peak:.4f} of the FMA "
        f"ceiling ({head_flops / rl.PEAK_FLOPS[torch.float32]:.4f} of the published peak), "
        f"{head_sins:.6e} transcendentals/s = {head_sins / sin_peak:.4f} of the "
        f"straight-line sin ceiling, "
        f"{head_rate * head_cost['bytes_per_member_step'] / hbm_peak:.6f} of the memory "
        f"ceiling")
    summary.update({
        "fma_ceiling_flops": fma_peak, "sin_ceiling_per_sec": sin_peak,
        "hbm_ceiling_bytes_per_sec": hbm_peak,
        "fused_flops_per_member_step": head_cost["flops_per_member_step"],
        "fused_transcendentals_per_member_step": head_cost["transcendentals_per_member_step"],
        "fused_bytes_per_member_step": head_cost["bytes_per_member_step"],
        "headline_flops_share_of_fma_ceiling": head_flops / fma_peak,
        "headline_sin_share_of_sin_ceiling": head_sins / sin_peak,
    })

    # the probes' rows at the reference's default sizes and the best layouts,
    # on random inputs: the kernel's output against the plain version's
    # first, then each timed as the probes are (queued calls, the median of
    # windows), with no output allocated inside a timed window
    elems = 64 * 16 * 1024
    gd = torch.Generator(device=dev).manual_seed(12)
    x1 = 1.0 + torch.rand(elems, device=dev, generator=gd)
    x5 = torch.rand(elems, device=dev, generator=gd)
    a_big = torch.randn(512 * 1024 * 1024 // 4, device=dev, generator=gd)

    def queued_ms(fn, reps=10, windows=5):
        """The median device ms per call over ``windows`` queued windows."""
        fn()  # warm: the allocator then holds the output's block
        ms = sorted(time_queued(fn, reps)[0] for _ in range(windows))
        return ms[windows // 2], ms

    probe_calls = {
        "fma_probe": (lambda: rl.fma_chain(x1, 16384, chains=best_fma[0], block=best_fma[1]),
                      lambda: rl.fma_chain_plain(x1, 16384), None,
                      elems * 2 * 16384 / fma_peak,
                      rl.bound(elems * 2 * 16384, 2 * elems * 4),
                      f"fma_probe (K3a) {elems} float32 x 16384 reps, chains {best_fma[0]}, "
                      f"block {best_fma[1]}"),
        "sin_probe": (lambda: rl.sin_chain(x5, 1024, chains=best_sin[0], block=best_sin[1]),
                      lambda: rl.sin_chain_plain(x5, 1024), None,
                      elems * 1024 / sin_peak,
                      rl.sin_probe_bound(elems, 1024),
                      f"sin_probe (K3b) {elems} float32 x 1024 reps, chains {best_sin[0]}, "
                      f"block {best_sin[1]}"),
        "add_one": (lambda: rl.add_one(a_big, blocks=best_hbm),
                    lambda: rl.add_one_plain(a_big), lambda: torch.add(a_big, 1.0),
                    2 * a_big.numel() * 4 / hbm_peak,
                    rl.bound(a_big.numel(), 2 * a_big.numel() * 4),
                    f"add_one (K3c) 512 MiB float32, {best_hbm} blocks"),
    }
    for name, (kern, plain, lib, probe_s, (bound_ms, bound_by), label) in probe_calls.items():
        p1, want = time_call(plain, 1)
        got = kern()
        check_probe(name, got, want, label)
        del got, want
        ms, windows = queued_ms(kern)
        lib_ms = None if lib is None else queued_ms(lib)[0]
        p2 = time_call(plain, 1)[0]
        extra = ""
        if name == "add_one":
            # the earlier timing's window: its two alternating outputs
            # allocated afresh inside it (time_call keeps the last one)
            torch.cuda.empty_cache()
            fresh = time_call(kern, 10)[0]
            extra = f", {fresh:.4f} ms with its two outputs allocated inside the window"
        log(f"phase 12: {label}: kernel vs plain {k3_err[name]:.3e}; kernel {ms:.4f} ms (median "
            f"of {', '.join(f'{w:.4f}' for w in windows)}; the probe's {probe_s * 1e3:.4f} ms"
            f"{extra}), plain {(p1 + p2) / 2:.3f} ms ({p1:.3f}, {p2:.3f}), bound "
            f"{bound_ms:.4f} ms ({bound_by})"
            + ("" if lib_ms is None else f", one PyTorch call {lib_ms:.4f} ms"))
        entries.append({
            "name": label, "route": "cuda", "source": PROBE_SOURCE,
            "replaces": PROBE_REPLACES[name], "launches": counts[name],
            "max_abs_err": k3_err[name], "ms": ms,
            "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    del x1, x5, a_big
    torch.cuda.empty_cache()

    # ---- phase 13: the sweep ------------------------------------------------------
    stamp(13)
    rng = np.random.default_rng(7)
    sweep_np = {"masses": 1.0 + 0.05 * rng.standard_normal((BATCH, 20))}
    sweep_np["lengths"] = np.tile(ex20.system.params["lengths"].cpu().numpy(), (BATCH, 1))
    sweep_np["gravity"] = 5.0 + 0.1 * rng.standard_normal(BATCH)
    sys_sw = ex20.system.replace_params(
        params_from_numpy(sweep_np, device=dev, dtype=torch.float32))
    forms_sw = sys_sw.fused_forms(sys_sw)
    st_sw = fused_stepper(forms_sw, iters=(2, 0), compensated=True, steps_per_call=spc)
    state_sw, table_sw = st_sw.init(ph)
    sw_kw = dict(iters=(2, 0), compensated=True, steps_per_call=spc, coef=table_sw)

    def sw_kern():
        return fused_step_kernel(forms_sw, state_sw, SWEEP_DT, **sw_kw)

    def sw_plain():
        return fused_step_reference(forms_sw, state_sw, SWEEP_DT, **sw_kw)

    k_out = sw_kern()
    p1, p_out = time_call(sw_plain, 1)
    worst_sw, errs, failures = compare_states(k_out, p_out, "float32")
    log(f"phase 13 {'FAILED' if failures else 'ok'}: per-member kernel vs plain, 16384 x "
        f"chain-20 float32 (2,0) kahan, one {spc}-step launch: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if failures:
        raise AssertionError("per-member kernel disagrees with its plain version: "
                             + "; ".join(failures))
    ex5s = chain(n_links=5, fused_solver="semiseparable", device=dev, dtype=torch.float64)
    rng5 = np.random.default_rng(13)
    sys5s = ex5s.system.replace_params(params_from_numpy({
        "masses": 1.0 + 0.05 * rng5.standard_normal((1000, 5)), "lengths": np.ones((1000, 5)),
        "gravity": 5.0 + 0.1 * rng5.standard_normal(1000)}, device=dev, dtype=torch.float64))
    lib = make_stepper(sys5s, "leapfrog", iters=(3, 2))
    fus = make_stepper(sys5s, "leapfrog_fused", iters=(3, 2))
    c_lib, c_fus = lib.init(ph5), fus.init(ph5)
    for _ in range(2):
        c_lib, c_fus = lib.step(c_lib, dt5), fus.step(c_fus, dt5)
    a, b = lib.extract(c_lib), fus.extract(c_fus)
    err_sw = max(float((a.q - b.q).abs().max()), float((a.p - b.p).abs().max()))
    log(f"phase 13: per-member kernel vs library leapfrog, chain-5 float64 (3,2), 1000 "
        f"swept members, 2 steps: {err_sw:.2e}")
    if not err_sw <= PHYSICS_TOL:
        raise AssertionError(f"per-member kernel vs library leapfrog: {err_sw:.3e}")

    marks = []
    t0 = time.perf_counter()
    (sw_final, sw_drift), counts = counted(lambda: evolve_ensemble_chunked(
        sys_sw, ph, SWEEP_DT, SWEEP_STEPS, chunk_steps=chunk, method="leapfrog_fused",
        iters=(2, 0), compensated=True, drift_every=1000, drift_dtype=torch.float64,
        callback=on_chunk, steps_per_call=spc))
    expect_counts("sweep", counts, fused_step=SWEEP_STEPS // spc,
                  spd_solve=1 + SWEEP_STEPS // 1000)
    if not all_finite(sw_final.q, sw_final.p, sw_drift) or tuple(sw_final.q.shape) != (BATCH, 20):
        raise AssertionError("sweep output is not finite or not (16384, 20)")
    sw_rate, sw_first, sw_chunks = steady_rate(marks, t0, BATCH, chunk)
    sw_max = float(sw_drift.max())
    log(f"phase 13: sweep 16384 x chain-20 float32 (2,0) kahan dt={SWEEP_DT}, "
        f"{SWEEP_STEPS} steps: {sw_rate:.6e} member-steps/s over {sw_chunks} steady chunks "
        f"(first chunk {sw_first:.3f} s; {sw_rate / head_rate:.4f} of the headline), "
        f"max|dH/H0| {sw_max:.6e}, launches {counts}")
    if not sw_max < DRIFT_BOUND:
        raise AssertionError(f"sweep drift {sw_max:.3e} >= {DRIFT_BOUND}")
    k1, _ = time_queued(sw_kern, 100)
    k2, _ = time_queued(sw_kern, 100)
    p2, _ = time_call(sw_plain, 1)
    bound_ms, bound_by, _ = k1_bound(sys_sw, "leapfrog_fused", (2, 0), True, BATCH, spc)
    log(f"phase 13: per-member kernel {(k1 + k2) / 2:.4f} ms per launch ({k1:.4f}, {k2:.4f}), "
        f"plain {(p1 + p2) / 2:.2f} ms ({p1:.2f}, {p2:.2f}), bound {bound_ms:.4f} ms "
        f"({bound_by})")
    entries.append({
        "name": "fused_step semiseparable n=20 float32 kahan (2,0) per-member tables",
        "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": counts["fused_step"], "max_abs_err": worst_sw, "ms": (k1 + k2) / 2,
        "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    })
    summary.update({"sweep_member_steps_per_sec": sw_rate, "sweep_max_drift": sw_max,
                    "sweep_steps": SWEEP_STEPS})
    del state_sw, table_sw, k_out, p_out

    # ---- phase 14: order 4 ---------------------------------------------------
    stamp(14)
    forms20 = ex20.system.fused_forms(ex20.system)
    st_o4 = fused_stepper(forms20, iters=(2, 0), compensated=True, steps_per_call=spc,
                          composition=SUZUKI4_COMPOSITION)
    state_o4 = st_o4.init(ph)
    coef20 = coef_table(forms20, dev, torch.float32)
    o4_kw = dict(iters=(2, 0), compensated=True, steps_per_call=spc,
                 composition=SUZUKI4_COMPOSITION)

    def o4_kern():
        return fused_step_kernel(forms20, state_o4, ORDER4_DT, coef=coef20, **o4_kw)

    def o4_plain():
        return fused_step_reference(forms20, state_o4, ORDER4_DT, **o4_kw)

    k_out = o4_kern()
    p1, p_out = time_call(o4_plain, 1)
    worst_o4, errs, failures = compare_states(k_out, p_out, "float32")
    log(f"phase 14 {'FAILED' if failures else 'ok'}: suzuki4 kernel vs plain, 16384 x "
        f"chain-20 float32 (2,0) kahan, one {spc}-step launch: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if failures:
        raise AssertionError("suzuki4 kernel disagrees with its plain version: "
                             + "; ".join(failures))
    marks = []
    t0 = time.perf_counter()
    (o4_final, o4_drift), counts = counted(lambda: evolve_ensemble_chunked(
        ex20.system, ph, ORDER4_DT, ORDER4_STEPS, chunk_steps=chunk, method="suzuki4_fused",
        iters=(2, 0), compensated=True, drift_every=1000, drift_dtype=torch.float64,
        callback=on_chunk, steps_per_call=spc))
    expect_counts("order 4", counts, fused_step=ORDER4_STEPS // spc,
                  spd_solve=1 + ORDER4_STEPS // 1000)
    if not all_finite(o4_final.q, o4_final.p, o4_drift) or tuple(o4_final.q.shape) != (BATCH, 20):
        raise AssertionError("order-4 output is not finite or not (16384, 20)")
    o4_rate, o4_first, o4_chunks = steady_rate(marks, t0, BATCH, chunk)
    o4_max = float(o4_drift.max())
    log(f"phase 14: suzuki4_fused 16384 x chain-20 float32 (2,0) kahan dt={ORDER4_DT}, "
        f"{ORDER4_STEPS} steps: {o4_rate:.6e} member-steps/s over {o4_chunks} steady chunks "
        f"(first chunk {o4_first:.3f} s; {o4_rate / head_rate:.4f} of the headline), "
        f"max|dH/H0| {o4_max:.6e}, launches {counts}")
    if not o4_max < DRIFT_BOUND:
        raise AssertionError(f"order-4 drift {o4_max:.3e} >= {DRIFT_BOUND}")
    k1, _ = time_queued(o4_kern, 50)
    k2, _ = time_queued(o4_kern, 50)
    p2, _ = time_call(o4_plain, 1)
    bound_ms, bound_by, _ = k1_bound(ex20.system, "suzuki4_fused", (2, 0), True, BATCH, spc)
    log(f"phase 14: suzuki4 kernel {(k1 + k2) / 2:.4f} ms per launch ({k1:.4f}, {k2:.4f}), "
        f"plain {(p1 + p2) / 2:.2f} ms ({p1:.2f}, {p2:.2f}), bound {bound_ms:.4f} ms "
        f"({bound_by})")
    entries.append({
        "name": "fused_step semiseparable n=20 float32 kahan (2,0) suzuki4 composition",
        "route": "cuda", "source": SOURCE, "replaces": REPLACES,
        "launches": counts["fused_step"], "max_abs_err": worst_o4, "ms": (k1 + k2) / 2,
        "plain_ms": (p1 + p2) / 2, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
    })
    summary.update({"order4_member_steps_per_sec": o4_rate, "order4_max_drift": o4_max,
                    "order4_steps": ORDER4_STEPS})
    del state_o4, k_out, p_out

    # ---- phase 15: the model families ------------------------------------------
    stamp(15)
    phase_families(dev, entries, summary)

    # ---- phase 16: the chain's Möbius and L⁻¹ forms -------------------------------
    stamp(16)
    phase_chain_solvers(dev, ph, head_rate, ptxas["chain_variants"], entries, summary)

    # ---- phase 17: gradients at full width ---------------------------------------
    stamp(17)
    phase_gradients(dev, ph, entries, summary)

    # ---- phase 18: a user's own family on the generated kernel ---------------------
    stamp(18)
    phase_user_family(dev, user_builds, entries, summary)

    # ---- phase 19: the fixed-step default, gauss4, on the library path ----------
    stamp(19)
    phase_gauss4(dev, entries, summary, checks)

    # ---- phase 20: the tools and examples ------------------------------------------
    stamp(20)
    phase_tools(dev, entries, summary)

    # ---- phase 21: K1's chain cases at 20 and 40 links; the sharded driver -----------
    stamp(21)
    phase_chain_cases(dev, chain_checked, entries, summary)
    late_pool.shutdown()
    t_sharded = time.perf_counter()
    phase_sharded(dev, summary)
    log(f"phase 21 (b) took {time.perf_counter() - t_sharded:.1f} s")
    log(f"phases done {time.perf_counter() - t_main:.1f} s into the run")

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    log(json.dumps({
        "headline_member_steps_per_sec": head_rate, "headline_max_drift": max_drift,
        "headline_steps": n_steps, "dp_member_steps_per_sec": dp_rate,
        "control_uncompensated_max_drift": ctl_max, **summary,
    }))
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(gauss4_checks_main() if sys.argv[1:] == [GAUSS_CHECKS_FLAG] else main())
