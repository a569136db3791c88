#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout; needs one card

Builds the hand-written kernels (``hamilton_tpu_torch/csrc/fused_step.cu``,
``csrc/chain_variants.cu``, ``csrc/family_step.cu``, ``csrc/batched_spd.cu``
and ``csrc/roofline_probes.cu``, one nvcc each or one a part, and
``csrc/user_family_step.cu`` around the generated forms of the elastic
pendulum and a 3-point Bézier, all at once), then runs these phases and
raises as soon as one fails:

1. kernel against its plain PyTorch version: one 50-step call on a ragged
   batch of 1000 members, chain-20 (semiseparable, ``(2,0)``, Kahan) and the
   double pendulum (dense, ``(2,1)``), each in float64 and float32;
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
   on B=1000 and B=16384 at n = 3, 20, 32 in float32 and float64 (random SPD
   K, and √M·J with m = 2n, from a seed), and each kernel's device time at
   16384 × 20 beside its plain version's;
8. adaptive GSL-RKF45 ``evolve_ham`` at full width (``bench.py::
   phase_adaptive``): 16384 × chain-20, one shared controller over t ∈ [0, 1],
   float64 at GSL's eps and float32 at eps 1e-6 — exactly six K2a launches
   per attempt, not saturated, finite, and in float64 ``max|ΔH/H₀|`` under
   the bound taken from the JAX package's CPU run;
9. that adaptive path on the card (the kernels) against the CPU (the plain
   versions): 8 members, float64, shared and per-member controllers —
   agreement to 1e-12 and the same step counts;
10. the library leapfrog at full width: ``evolve_ensemble_final(method=
    "leapfrog", iters=(2, 0), compensated=True)`` on 16384 × chain-20,
    float32, 2000 steps, float64 drift every 1000 — one K2b and five K2c
    launches per step;
11. the J route at full width: a 20-link chain given by its coordinate map
    and potential alone (no analytic Jacobian or mass matrix), 200 library
    leapfrog steps on 16384 members in float32 (K2e, K2c; K2d in its float64
    drift samples), and ``evolve_ham`` of 16384 springs in float64 over 10
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
    through one 50-step fused launch (the kernel forward, the replay
    backward) against 50 library-leapfrog steps (backward on K2) to 1e-9
    relative, and against a central difference on one mass; (c) float32
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
    run's shape, with its plain version, the host's issue and its bound.

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

import json
import math
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
K2_SOURCE = "hamilton_tpu_torch/csrc/batched_spd.cu"
# The K2 kernels compute their plain versions' IEEE operations in the same
# order (round-to-nearest intrinsics, never fused into an FMA), so the two
# agree bit for bit: every reading on an H100 80GB HBM3 was 0, and the limit
# is equality.  A nonzero difference means the kernel no longer does the
# plain version's arithmetic.
K2_TOL = 0.0
K2_SIZES = (3, 20, 32)
K2_BATCHES = (1000, BATCH)
# The dtype each K2 entry runs in on its main path at n = 20 (the adaptive
# float64 run and the drift samplers for K2a and K2d, the float32 library
# leapfrogs for K2b, K2c and K2e): the kernels line reports that time.
K2_MAIN_DTYPE = {"spd_solve_batched": "float64", "cholesky_batched": "float32",
                 "cho_solve_batched": "float32", "spd_solve_jac": "float64",
                 "cholesky_jac": "float32"}
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
# Card against CPU in float32 over 20 leapfrog steps of the J route: ulps of
# sin/cos through chain-20's K; the reading is 6.0e-8 (one ulp of |q| ~ 0.5).
CPU_TOL_F32 = 6e-7
LEAPFROG_STEPS = 2000
J_STEPS = 200
# the sweep and order-4 paths (bench.py:568-610 with ROADMAP's 2e5-step
# horizon at dt=5e-4; bench.py:539, the suzuki4_fused datapoint)
SWEEP_STEPS, SWEEP_DT = 200_000, 5e-4
ORDER4_STEPS, ORDER4_DT = 100_000, 1e-3
# the probes against their plain versions: K3a does one single-rounding FMA
# a rep on both sides, and K3c one add, so both are equal bit for bit; K3b
# is libdevice sinf against PyTorch's float32 sin on the card (every reading
# on an H100 80GB HBM3 has been 0: the same libdevice function), and the
# limit allows a few ulps of (0, 1) from a differing sin
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


_KERNEL_RE = re.compile(
    r"fused_step_kernelI([fd])Li(\d+)ELb([01])ELb([01])ELb([01])ELb([01])E")
_K2_RE = re.compile(r"(factor_solve_kernel|factor_kernel|substitute_kernel)I([fd])(?:Lb([01])E)?")
_K2_NAMES = {("factor_solve_kernel", "0"): "spd_solve (K2a)",
             ("factor_kernel", "0"): "cholesky (K2b)",
             ("substitute_kernel", None): "cho_solve (K2c)",
             ("factor_solve_kernel", "1"): "spd_solve_jac (K2d)",
             ("factor_kernel", "1"): "cholesky_jac (K2e)"}


_FAMILY_RE = re.compile(r"family_step_kernelI([fd])Li(\d+)ELb([01])ELb([01])ELb([01])E")
_K3_RE = re.compile(r"(fma_probe_kernel|sin_probe_kernel|add_one_kernel)(?:ILi(\d+)E)?")


def _k1_label(m):
    t, n, semi, comp, per_member, composed = m.groups()
    return (f"{'float' if t == 'f' else 'double'} n={n} "
            f"{'semiseparable' if semi == '1' else 'dense'}"
            f"{' kahan' if comp == '1' else ''}{' per-member' if per_member == '1' else ''}"
            f"{' composed' if composed == '1' else ''}")


def _family_label(m):
    t, code, comp, per_member, composed = m.groups()
    return (f"{'float' if t == 'f' else 'double'} {FAMILY_CODES[int(code)]}"
            f"{' kahan' if comp == '1' else ''}{' per-member' if per_member == '1' else ''}"
            f"{' composed' if composed == '1' else ''}")


# chain_variant_kernel<T, case, ...> or, for L⁻¹, linv_kernel<T, n, ...>
_VARIANT_RE = re.compile(r"(?:chain_variant_kernelI([fd])Li(\d+)E|linv_kernelI([fd])Li(\d+)E)"
                         r"Lb([01])ELb([01])ELb([01])E")


def _variant_label(m):
    t, code, lt, n, comp, per_member, composed = m.groups()
    form = CHAIN_CODES[int(code)] if t else f"linv n={n}"
    t = t or lt
    return (f"{'float' if t == 'f' else 'double'} {form}"
            f"{' kahan' if comp == '1' else ''}{' per-member' if per_member == '1' else ''}"
            f"{' composed' if composed == '1' else ''}")


_USER_RE = re.compile(r"user_family_kernelI([fd])Li(\d)ELb([01])ELb([01])E")


def _user_label(m):
    t, table, comp, composed = m.groups()
    return (f"{'float' if t == 'f' else 'double'} {USER_TABLES[int(table)]}"
            f"{' kahan' if comp == '1' else ''}{' composed' if composed == '1' else ''}")


def _k3_label(m):
    kind, chains = m.groups()
    return f"{kind}{f' chains={chains}' if chains else ''}"


def _k2_label(m):
    kind, t, from_j = m.groups()
    return f"{'float' if t == 'f' else 'double'} {_K2_NAMES[(kind, from_j)]}"


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


def compare_states(kernel_out, plain_out, dtype_name):
    """Errors of the kernel's state against the plain version's under
    :data:`TOL`: ``(largest q/p absolute error, errors, failures)``.  A
    compensated state is judged on its compensated sums q+cq and p+cp."""
    k, r = kernel_out.double(), plain_out.double()
    diff = k - r
    errs = {"q": diff[0], "p": diff[1]}
    if k.shape[0] == 6:
        errs["q+cq"], errs["p+cp"] = diff[0] + diff[2], diff[1] + diff[3]
    errs["a_est"], errs["vdot_est"] = diff[-2], diff[-1]
    tol = TOL[dtype_name]
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


def k2_inputs(batch, n, dtype, device, seed):
    """Random SPD K (B, n, n), √M·J (B, 2n, n) and b (B, n) from a seed."""
    import torch
    from hamilton_tpu_torch.ops.batched_spd import jac_scaled

    g = torch.Generator().manual_seed(seed)
    a = torch.randn(batch, n, n, generator=g, dtype=torch.float64)
    k = a @ a.mT + n * torch.eye(n, dtype=torch.float64)
    j = 0.3 * torch.randn(batch, 2 * n, n, generator=g, dtype=torch.float64)
    j[:, :n] += torch.eye(n, dtype=torch.float64)
    inertia = 1.0 + torch.rand(2 * n, generator=g, dtype=torch.float64)
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
            if solver == "linv":  # its layout as built, registers and spills
                lanes, block, smem, blocks = kernels.linv_layout(
                    0, CHAIN_CODES.index(f"linv n={n}"))
                by_name = {name: (r, st, ld) for name, r, st, ld in regs}
                r, st, ld = by_name[f"float linv n={n} kahan"]
                log(f"phase 16: linv n={n} float32 kahan: {lanes} lanes a member, {block} "
                    f"threads and {smem} B of shared memory a block, {blocks} blocks "
                    f"({blocks * block // 32} warps) an SM, {r} registers, spill stores "
                    f"{st} B, spill loads {ld} B")
                summary[f"linv_n{n}_lanes"] = lanes
                summary[f"linv_n{n}_shared_bytes"] = smem
                summary[f"linv_n{n}_warps_per_sm"] = blocks * block // 32
                summary[f"linv_n{n}_registers"] = r
                summary[f"linv_n{n}_spills"] = [st, ld]
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
    # (q₀, p₀) and the 20 shared masses through one 50-step fused launch,
    # against 50 library-leapfrog steps (their backward on K2) and a central
    # difference on one mass
    ex = chain(n_links=20, fused_solver="semiseparable", device=dev, dtype=f64)
    ph64 = ph.astype(f64)
    m0 = ex.system.params["masses"].detach().clone()
    dt = 5e-4

    def loss_of(method, masses, q0, p0):
        system = ex.system.replace_params(dict(ex.system.params, masses=masses))
        fused = method == "leapfrog_fused"
        st = make_stepper(system, method, iters=(3, 2), steps_per_call=50 if fused else 1)
        carry = st.init(Phase(q0, p0))
        step_dt = dt if fused else torch.tensor(dt, dtype=f64)
        for _ in range(1 if fused else 50):
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
    log(f"phase 17: float64 (3,2) gradient, {BATCH} x chain-20, 50 steps: fused (one launch, "
        f"the replay backward) vs library leapfrog (50 steps, backward on K2): relative "
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


def _launch_name(entry):
    """The name an entry's launches are counted under."""
    from hamilton_tpu_torch import kernels

    return next(name for name, fn in kernels.LAUNCHERS.items() if fn is entry.launch)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    if not (REPO / "hamilton_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(
            f"chip_smoke: hamilton_tpu_torch/ not found beside {Path(__file__).name}; "
            f"run it from the root of a checkout of the repository"
        )
    sys.path.insert(0, str(REPO))

    from hamilton_tpu_torch import kernels
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
    with ThreadPoolExecutor(max_workers=len(headers)) as pool:
        user_futures = {label: pool.submit(kernels.build_user_family, header)
                        for label, header in headers.items()}
        builds = kernels.build_all()
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

    # ---- phase 1: kernel against plain version ---------------------------
    phase1_failures = []
    for label, make, iters, comp, dt, seed in configs:
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[-1]
            ex = make(dtype)
            forms = ex.system.fused_forms(ex.system)
            st = fused_stepper(forms, iters=iters, compensated=comp, steps_per_call=50)
            state = st.init(jittered_phase(ex, 1000, dtype, dev, seed))
            k_out = fused_step_kernel(forms, state, dt, iters=iters,
                                      compensated=comp, steps_per_call=50)
            p_out = fused_step_reference(forms, state, dt, iters=iters,
                                         compensated=comp, steps_per_call=50)
            torch.cuda.synchronize()
            _, errs, failures = compare_states(k_out, p_out, dname)
            phase1_failures += [f"{label}: {f}" for f in failures]
            log(f"phase 1 {'FAILED' if failures else 'ok'}: {label} {dname} "
                f"B=1000 spc=50: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if phase1_failures:
        raise AssertionError("kernel disagrees with its plain version: "
                             + "; ".join(phase1_failures))

    # ---- phase 2: kernel against physics --------------------------------
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
    head_launches = counts["fused_step"]
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
    entries = []
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

    # the drift sampler's share of the headline: one float64 library
    # Hamiltonian of the 16384 x chain-20 state, as evolve_ensemble_chunked takes it
    sys64 = ex20.system.to(dtype=torch.float64)
    ph64 = final.astype(torch.float64)
    hamiltonian(sys64, ph64)
    h_ms, _ = time_call(lambda: hamiltonian(sys64, ph64), 5)
    log(f"phase 5: drift sample (float64 hamiltonian, 16384 x chain-20, K2a solve): "
        f"{h_ms:.3f} ms; {n_steps // 1000} samples in the headline")

    # ---- phase 6: control without compensation ------------------------------
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
    from hamilton_tpu_torch.ops.batched_spd import ENTRIES

    k2_rows = {e.name: {"max_abs_err": 0.0} for e in ENTRIES}
    for batch in K2_BATCHES:
        for n in K2_SIZES:
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).split(".")[-1]
                k, js, b = k2_inputs(batch, n, dtype, dev, 1000 * n + batch)
                row = []
                for e in ENTRIES:
                    args = k2_args(e, k, js, b)
                    got, want = e.kernel(*args), e.plain(*args)
                    torch.cuda.synchronize()
                    if not all_finite(got, want):
                        raise AssertionError(f"{e.name} B={batch} n={n} {dname}: not finite")
                    err = float((got - want).abs().max())
                    k2_rows[e.name]["max_abs_err"] = max(k2_rows[e.name]["max_abs_err"], err)
                    row.append(f"{e.name} {err:.1e}")
                    if not err <= K2_TOL:
                        raise AssertionError(f"{e.name} B={batch} n={n} {dname}: kernel "
                                             f"differs from its plain version by {err:.3e}")
                log(f"phase 7 ok: B={batch} n={n} {dname}: " + ", ".join(row))
    # one PyTorch call computing each entry's function on its operands, the
    # yardstick beside the kernel (the port never calls these); K2d and K2e
    # have none (forming K is a second call)
    k2_library = {
        "spd_solve_batched": lambda k, b: torch.linalg.solve(k, b),
        "cholesky_batched": torch.linalg.cholesky,
        "cho_solve_batched": lambda low, b: torch.cholesky_solve(b[..., None], low),
    }
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        k, js, b = k2_inputs(BATCH, 20, dtype, dev, 7)
        for e in ENTRIES:
            args = k2_args(e, k, js, b)
            e.kernel(*args)
            e.plain(*args)  # warm-up
            # in turns on one card: plain, kernel, kernel, plain
            p1, _ = time_call(lambda: e.plain(*args), 2)
            k1, _ = time_queued(lambda: e.kernel(*args), 100)
            k2, _ = time_queued(lambda: e.kernel(*args), 100)
            p2, _ = time_call(lambda: e.plain(*args), 2)
            lib_ms = None
            if e.name in k2_library:
                lib = k2_library[e.name]
                lib(*args)  # warm-up
                l1, _ = time_call(lambda: lib(*args), 20)
                l2, _ = time_call(lambda: lib(*args), 20)
                lib_ms = (l1 + l2) / 2
            log(f"phase 7: {e.name} 16384 x n=20 {dname}: kernel {(k1 + k2) / 2:.4f} ms "
                f"({k1:.4f}, {k2:.4f}), plain {(p1 + p2) / 2:.3f} ms ({p1:.3f}, {p2:.3f})"
                + ("" if lib_ms is None else f", one PyTorch call {lib_ms:.4f} ms "
                   f"({l1:.4f}, {l2:.4f})"))
            if K2_MAIN_DTYPE[e.name] == dname:
                k2_rows[e.name].update(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, dtype=dname,
                                       library_ms=lib_ms)

    # ---- phase 8: adaptive GSL-RKF45 at full width --------------------------
    from hamilton_tpu_torch import Config, Phase, evolve_ham, spring, to_phase
    from hamilton_tpu_torch.integrators import adaptive

    summary = {}
    for dtype, eps in ((torch.float64, GSL_EPS), (torch.float32, ADAPTIVE_F32_EPS)):
        dname = str(dtype).split(".")[-1]
        exa = chain(n_links=20, device=dev, dtype=dtype)
        pha = jittered_phase(exa, BATCH, dtype, dev, 0)
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
            k2_rows["spd_solve_batched"]["launches"] = counts["spd_solve"]
            if not drift_a < ADAPTIVE_DRIFT_BOUND:
                raise AssertionError(f"adaptive float64 drift {drift_a:.3e} >= "
                                     f"{ADAPTIVE_DRIFT_BOUND}")
            ex64, ph64a = exa, pha

    # ---- phase 9: the adaptive path on the card against the CPU -------------
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

    # ---- phase 10: the library leapfrog at full width -----------------------
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
    k2_rows["cholesky_batched"]["launches"] = counts["cholesky"]
    k2_rows["cho_solve_batched"]["launches"] = counts["cho_solve"]

    # ---- phase 11: the J route at full width --------------------------------
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
    k2_rows["cholesky_jac"]["launches"] = counts["cholesky_jac"]
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
    k2_rows["spd_solve_jac"]["launches"] = counts["spd_solve_jac"]
    sp_card = evolve_ham(sp.system, Phase(ph_sp.q[:1000], ph_sp.p[:1000]), ts)
    sp_cpu = evolve_ham(spring(device="cpu", dtype=torch.float64).system,
                        Phase(ph_sp.q[:1000].cpu(), ph_sp.p[:1000].cpu()), ts)
    err = max(float((sp_card.q.cpu() - sp_cpu.q).abs().max()),
              float((sp_card.p.cpu() - sp_cpu.p).abs().max()))
    log(f"phase 11: spring evolve_ham, 1000 members, card vs CPU: {err:.3e}")
    if not err <= CPU_TOL_F64:
        raise AssertionError(f"spring evolve_ham: card and CPU differ by {err:.3e}")

    for e in ENTRIES:
        r = k2_rows[e.name]
        if not r.get("launches"):
            raise AssertionError(f"{e.name}: its main path launched it no time")
        dtype = getattr(torch, r["dtype"])
        ops, nbytes = k2_work(e, BATCH, 20, 40, dtype)
        bound_ms, bound_by = rl.bound(ops, nbytes, dtype)
        entries.append({
            "name": f"{e.name} n=20{' m=40' if e.from_jac else ''} {r['dtype']}",
            "route": "cuda", "source": K2_SOURCE,
            "replaces": e.replaces, "launches": r["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": r["library_ms"],
        })

    # ---- phase 12: the roofline path -----------------------------------------
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
    log(f"phase 12: ceilings on {card}: float32 FMA {fma_peak:.6e} FLOP/s "
        f"({fma_peak / rl.PEAK_FLOPS[torch.float32]:.4f} of the published 67 TFLOP/s; "
        f"chains {best_fma[0]}, block {best_fma[1]}), sinf {sin_peak:.6e} sin/s (chains "
        f"{best_sin[0]}, block {best_sin[1]}; {fma_peak / sin_peak:.2f} flops per sin), "
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
        f"{head_sins:.6e} transcendentals/s = {head_sins / sin_peak:.4f} of the sin ceiling, "
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
                      rl.bound(elems * 2 * 1024, 2 * elems * 4),
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
    from hamilton_tpu_torch.convert import params_from_numpy

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
    phase_families(dev, entries, summary)

    # ---- phase 16: the chain's Möbius and L⁻¹ forms -------------------------------
    phase_chain_solvers(dev, ph, head_rate, ptxas["chain_variants"], entries, summary)

    # ---- phase 17: gradients at full width ---------------------------------------
    phase_gradients(dev, ph, entries, summary)

    # ---- phase 18: a user's own family on the generated kernel ---------------------
    phase_user_family(dev, user_builds, entries, summary)

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
    sys.exit(main())
