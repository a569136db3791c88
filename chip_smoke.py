#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout; needs one card

Builds the hand-written fused-step kernel (``hamilton_tpu_torch/csrc/
fused_step.cu``) with nvcc, then runs five phases and raises as soon as one
fails:

1. kernel against its plain PyTorch version: one 50-step call on a ragged
   batch of 1000 members, chain-20 (semiseparable, ``(2,0)``, Kahan) and the
   double pendulum (dense, ``(2,1)``), each in float64 and float32;
2. kernel against physics: float64 chain-5 ``(3,2)`` against the port's
   library leapfrog over two steps;
3. the headline: ``evolve_ensemble_chunked`` on 16384 × chain-20, float32,
   ``(2,0)``, Kahan, dt=5e-4, 2e5 steps in chunks of 1e4, 50 steps per
   launch, float64 drift sampled every 1000 steps — exactly one launch per
   50 steps, finite output, ``max|ΔH/H₀| < 1e-6``;
4. the double pendulum: 16384 members, float32, ``(2,1)``, dt=1e-3, 1e4
   steps through ``evolve_ensemble_final`` without drift tracking, called
   20 times back to back so the timed window spans a few hundred ms;
5. the plain version's time beside the kernel's for one 50-step call at the
   shapes of phases 3 and 4, with their agreement; the kernel's device time
   per launch (launches queued behind a held stream) and the host's time to
   issue one;
6. control: the headline run again without Kahan compensation, whose drift
   must exceed the bound of phase 3 — so that bound can see a kernel that
   loses the compensation.

Prints the card's name and power limit, the CUDA version, the build time
and nvcc's register/spill report, one JSON line describing the kernel, and
as its last line ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


_KERNEL_RE = re.compile(r"fused_step_kernelI([fd])Li(\d+)ELb([01])ELb([01])E")


def ptxas_report(log_text: str):
    """nvcc's ``-Xptxas -v`` lines per kernel instantiation:
    ``[(name, registers, spill_stores, spill_loads)]``."""
    rows, current, spills = [], None, None
    for line in log_text.splitlines():
        m = _KERNEL_RE.search(line)
        if m and "Compiling entry" in line:
            t, n, semi, comp = m.groups()
            current = (f"{'float' if t == 'f' else 'double'} n={n} "
                       f"{'semiseparable' if semi == '1' else 'dense'}"
                       f"{' kahan' if comp == '1' else ''}")
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
    p = ph0.p.cpu().to(dtype).expand(batch, n).contiguous()
    return Phase(q.to(device=device, dtype=dtype), p.to(device))


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


def main() -> int:
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
        coef_table, fused_step_kernel, fused_step_reference, fused_stepper,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # ---- build ----------------------------------------------------------
    build = kernels.build_fused_step()
    log(f"build: {build.seconds:.1f} s ({build.path.name})")
    regs = ptxas_report(build.log)
    if not regs:
        raise AssertionError("nvcc printed no -Xptxas -v report")
    for name, nreg, st, ld in regs:
        log(f"ptxas: {name:<34} {nreg:3d} registers, spill stores {st} B, "
            f"spill loads {ld} B")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"nvcc: {line.strip()}")

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
    kernels.fused_step_launch.launches = 0
    t0 = time.perf_counter()
    final, drift = headline(True, on_chunk)
    torch.cuda.synchronize()
    head_launches = kernels.fused_step_launch.launches
    if head_launches != n_steps // spc:
        raise AssertionError(f"headline made {head_launches} kernel launches, "
                             f"expected {n_steps // spc}")
    if not (bool(torch.isfinite(final.q).all()) and bool(torch.isfinite(final.p).all())
            and bool(torch.isfinite(drift).all())):
        raise AssertionError("headline output is not finite")
    if tuple(final.q.shape) != (BATCH, 20):
        raise AssertionError(f"headline output shape {tuple(final.q.shape)}")
    max_drift = float(drift.max())
    steady = [marks[i] - marks[i - 1] for i in range(1, len(marks))]
    head_rate = BATCH * chunk * len(steady) / sum(steady)
    log(f"phase 3: headline 16384 x chain-20 float32 (2,0) kahan dt=5e-4, "
        f"{n_steps} steps: {head_rate:.6e} member-steps/s over {len(steady)} "
        f"steady chunks (first chunk {marks[0] - t0:.3f} s), "
        f"max|dH/H0| {max_drift:.6e}, {head_launches} launches")
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
    kernels.fused_step_launch.launches = 0
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
    def time_call(fn, reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, out

    def time_queued(fn, reps):
        """``(device ms, host ms)`` per call: the stream is held by a spin
        kernel while the host issues ``reps`` calls (host ms is that wall
        time per call), so the events then time the calls back to back on
        the card, free of the host's cost."""
        cycles = 10**8
        while True:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(cycles)
            start.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host = (time.perf_counter() - t0) / reps * 1e3
            held = not start.query()  # the card still spins: nothing ran yet
            end.record()
            end.synchronize()
            if held:
                return start.elapsed_time(end) / reps, host
            if cycles >= 10**10:
                raise AssertionError("the host could not queue the calls ahead of the card")
            cycles *= 4

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
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches, "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        })

    # the drift sampler's share of the headline: one float64 library
    # Hamiltonian of the 16384 x chain-20 state, as evolve_ensemble_chunked takes it
    sys64 = ex20.system.to(dtype=torch.float64)
    ph64 = final.astype(torch.float64)
    hamiltonian(sys64, ph64)
    h_ms, _ = time_call(lambda: hamiltonian(sys64, ph64), 5)
    log(f"phase 5: drift sample (float64 hamiltonian, 16384 x chain-20): {h_ms:.3f} ms; "
        f"{n_steps // 1000} samples in the headline")

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

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    log(json.dumps({
        "headline_member_steps_per_sec": head_rate, "headline_max_drift": max_drift,
        "headline_steps": n_steps, "dp_member_steps_per_sec": dp_rate,
        "control_uncompensated_max_drift": ctl_max,
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
