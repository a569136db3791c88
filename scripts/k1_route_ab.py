#!/usr/bin/env python3
"""K1's chain cases at 20 and 40 links: the hand-written kernel against the
generated one, in turns on one card.

    python3 scripts/k1_route_ab.py [--pairs 10] [--cap 900] [--rolled20] [CASE ...]

CASE is ``dense20`` (the reference's default chain, ``leapfrog_fused``
(2,1), dt = 1e-3), ``semiseparable40`` or ``dense40`` (its stress chain,
(2,0), dt = 5e-4); all three by default.  Each runs on 16384 members,
float32 with Kahan compensation, 50 steps a launch, on these kernels:

- ``hand``: ``csrc/fused_step.cu``'s one-thread template at that n and form
  (its own part of the build, ``kernels.FUSED_STEP_VARIANTS``; for a case
  the source does not instantiate, such as ``dense20``, which runs on the
  generated kernel, a copy of the source under ``_build/k1_route_ab/`` with
  the case added to its dispatch, built as the others, without FMA
  contraction);
- ``generated``: ``csrc/user_family_step.cu`` around the header that
  ``ops/fused_codegen.py`` makes from the chain's forms (its six parts,
  ``kernels.USER_FAMILY_PARTS``, each a unit of the build);
- with ``--rolled20``, ``hand rolled`` for ``dense20``: that copy's float32
  part built with ``-DHAMILTON_DENSE_UNROLL_MAX_N=16``, its dense loops
  rolled as they are beyond n = 24.

Every build runs at once, one nvcc each, each stopped after ``--cap``
seconds; each logs its seconds and ``-Xptxas -v`` registers and spills as it
ends (the parts and headers land where ``kernels`` looks for them).  Then
each kernel that built is held against the plain version over one step on
1000 members (float32, ``chip_smoke.TOL``), and ``--pairs`` rounds time the
routes in turn (the order rotating a round), each reading the device ms of
one launch from CUDA events around launches queued behind a held stream
(``utils.profiling.time_queued``).  Prints the card's name and power limit,
a line per build and reading, and a last line of JSON: ``{"card": ...,
"builds": {unit: {"seconds": s or null, "ptxas": [...]}}, "cases": {case:
{"max_err": {...}, "ms": {route: [...]}, "median_ms": {...}}}}``.  The log
also goes to ``chiprun_out/k1_route_ab.log`` line by line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import signal
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: case → (n, fused_solver, iters, dt)
CASES = {
    "dense20": (20, "dense", (2, 1), 1e-3),
    "semiseparable40": (40, "semiseparable", (2, 0), 5e-4),
    "dense40": (40, "dense", (2, 0), 5e-4),
}
BATCH = 16384
SPC = 50
CHECK_BATCH = 1000

_LOG = REPO / "chiprun_out" / "k1_route_ab.log"


def log(msg: str) -> None:
    print(msg, flush=True)
    with open(_LOG, "a") as f:
        f.write(msg + "\n")


def _nvcc(cmd, lib: Path, report: Path, cap: float):
    """Run nvcc into ``lib`` (atomically) with its report in ``report``;
    ``(seconds or None when stopped at the cap, report text)``."""
    tmp = lib.parent / f"{lib.stem}.{os.getpid()}.tmp.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # its own process group, so that the cap stops nvcc's cicc and ptxas too
    proc = subprocess.Popen([*cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=cap)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        tmp.unlink(missing_ok=True)
        return None, ""
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{stderr[-4000:]}")
    text = stdout + stderr
    report.write_text(text)
    os.replace(tmp, lib)
    return seconds, text


def _source_copy(where: Path, n: int, semi: bool, kernels) -> Path:
    """A copy of ``csrc/`` in ``where`` whose ``fused_step.cu`` also
    dispatches ``(n, semi)`` (as the variant after the source's own, where
    the source lacks it); the copied ``fused_step.cu``."""
    csrc = REPO / "hamilton_tpu_torch" / "csrc"
    where.mkdir(parents=True, exist_ok=True)
    for path in csrc.glob("*.cuh"):
        (where / path.name).write_text(path.read_text())
    text = (csrc / "fused_step.cu").read_text()
    if (n, semi) not in kernels.FUSED_STEP_VARIANTS:
        v = len(kernels.FUSED_STEP_VARIANTS)
        cond = "semiseparable" if semi else "!semiseparable"
        line = (f"  if ({cond} && n == {n}) return f(Variant<{v}, {n}, "
                f"{'true' if semi else 'false'}>{{}});\n")
        anchor = "  return -1;\n}\n\ntemplate <typename T>\nint launch_dispatch"
        if anchor not in text:
            raise RuntimeError("fused_step.cu's dispatch has changed: update _source_copy")
        text = text.replace(anchor, line + anchor)
    target = where / f"fused_step_{n}{'s' if semi else 'd'}.cu"
    target.write_text(text)
    return target


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--cap", type=float, default=900.0)
    ap.add_argument("--rolled20", action="store_true")
    ap.add_argument("cases", nargs="*", default=list(CASES))
    args = ap.parse_args(argv)
    _LOG.parent.mkdir(exist_ok=True)
    _LOG.write_text("")

    import torch

    import chip_smoke as cs
    import hamilton_tpu_torch as tp
    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.ops import fused_codegen
    from hamilton_tpu_torch.ops import fused_step as fs
    from hamilton_tpu_torch.utils.profiling import time_queued

    if not torch.cuda.is_available():
        raise SystemExit("k1_route_ab: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    log(f"card: {card}")
    f32 = torch.float32
    nvcc = kernels._nvcc()

    forms = {}
    for case in args.cases:
        n, solver, _, _ = CASES[case]
        system = tp.chain(n_links=n, fused_solver=solver, device=dev, dtype=f32).system
        forms[case] = system.fused_forms(system)

    # ---- every build at once, each stopped at the cap --------------------------
    units = {}  # label → (nvcc command, library, report, ptxas parser)
    copies = {}  # label → the library of a case built from a copy of the source
    scratch = REPO / "hamilton_tpu_torch" / "_build" / "k1_route_ab"
    for case in args.cases:
        n, solver, _, _ = CASES[case]
        semi = solver == "semiseparable"
        extras = [("", ())] + ([(" rolled", ("-DHAMILTON_DENSE_UNROLL_MAX_N=16",))]
                               if args.rolled20 and case == "dense20" else [])
        for dtype_code, tname in ((0, "float32"), (1, "float64")):
            for suffix, extra in extras:
                label = f"{case} hand{suffix} {tname}"
                if suffix and dtype_code:
                    continue
                if (n, semi) in kernels.FUSED_STEP_VARIANTS and not extra:
                    part = kernels.PARTS["fused_step"][1](dtype_code, n, semi)
                    src, lib, report = kernels._paths("fused_step", part)
                    cmd = [nvcc, *kernels._flags("fused_step", part), str(src)]
                else:
                    src = _source_copy(scratch / "csrc", n, semi, kernels)
                    v = (kernels.FUSED_STEP_VARIANTS.get((n, semi))
                         if (n, semi) in kernels.FUSED_STEP_VARIANTS
                         else len(kernels.FUSED_STEP_VARIANTS))
                    lib = scratch / f"lib{case}{suffix.strip()}-{tname}.so"
                    report = lib.with_suffix(".log")
                    cmd = [nvcc, *kernels.NVCC_FLAGS, "-fmad=false",
                           f"-DHAMILTON_PART={2 * v + dtype_code}", *extra, str(src)]
                    copies[label] = lib
                units[label] = (cmd, lib, report, (cs._KERNEL_RE, cs._k1_label))
        key, where, flags = kernels._user_family_paths(fused_codegen.generated(forms[case]).header)
        where.mkdir(parents=True, exist_ok=True)
        (where / "user_family.h").write_text(fused_codegen.generated(forms[case]).header)
        for part in range(kernels.USER_FAMILY_PARTS):
            units[f"{case} generated p{part}"] = (
                [nvcc, *flags, "-I", str(where), f"-DHAMILTON_PART={part}",
                 str(kernels.USER_FAMILY_TEMPLATE)],
                where / f"libuser_family-p{part}.so", where / f"build-p{part}.log",
                (cs._USER_RE, cs._user_label))
    builds = {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(units)) as pool:
        futures = {pool.submit(_nvcc, cmd, lib, report, args.cap): label
                   for label, (cmd, lib, report, _) in units.items()}
        for fut in as_completed(futures):
            label = futures[fut]
            seconds, text = fut.result()
            rows = cs.ptxas_report(text, *units[label][3]) if seconds is not None else []
            builds[label] = {"seconds": seconds, "ptxas": rows}
            log(f"build {label}: " + (f"nvcc {seconds:.1f} s" if seconds is not None
                                      else f"stopped at the {args.cap:.0f} s cap")
                + f" ({time.perf_counter() - t0:.1f} s into the builds)")
            for kname, nreg, st, ld in rows:
                log(f"  ptxas {kname:<45} {nreg:3d} registers, spill stores {st} B, "
                    f"spill loads {ld} B")

    # ---- each kernel against the plain version, then the rounds --------------
    out = {}
    for case in args.cases:
        n, solver, iters, dt = CASES[case]
        fm = forms[case]
        ex = tp.chain(n_links=n, fused_solver=solver, device=dev, dtype=f32)
        semisep = solver == "semiseparable"
        coef = fs.coef_table(fm, dev, f32)
        built = {label for label, b in builds.items() if b["seconds"] is not None}
        routes = [r for r in ("hand", "hand rolled") if f"{case} {r} float32" in built]
        if all(f"{case} generated p{part}" in built for part in range(kernels.USER_FAMILY_PARTS)):
            routes.insert(1, "generated")
        entries = {}
        for name in routes:
            lib = copies.get(f"{case} {name} float32")
            if lib is not None:
                entry = ctypes.CDLL(str(lib)).hamilton_fused_step
                entry.argtypes = kernels._SIGNATURES["fused_step"]["hamilton_fused_step"]
                entry.restype = ctypes.c_int
                entries[name] = entry
        weights = (ctypes.c_double * 1)(1.0)

        def route(name, state, spc):
            if name == "generated":
                return fs._generated_step(fm, state, dt, coef, True, iters[0], iters[1], spc,
                                          (1.0,))
            res = torch.empty_like(state)
            stream = torch.cuda.current_stream(dev).cuda_stream
            if name in entries:
                code = entries[name](0, n, int(semisep) | 2, coef.data_ptr(), state.data_ptr(),
                                     res.data_ptr(), state.shape[2], dt, iters[0], iters[1],
                                     spc, 1, weights, stream)
                if code != 0:
                    raise RuntimeError(f"{case} {name}: the kernel returned {code}")
                return res
            kernels.fused_step_launch(
                dtype_code=0, code=n, semiseparable=semisep, compensated=True,
                per_member=False, coef=coef.data_ptr(), state_in=state.data_ptr(),
                state_out=res.data_ptr(), batch=state.shape[2], dt=dt, iters_p=iters[0],
                iters_q=iters[1], steps_per_call=spc, weights=(1.0,), stream=stream)
            return res

        rec = out[case] = {"max_err": {}, "ms": {r: [] for r in routes}}
        if not routes:
            log(f"{case}: no kernel built")
            continue
        stepper = fs.fused_stepper(fm, iters=iters, compensated=True, steps_per_call=SPC)
        small = stepper.init(cs.jittered_phase(ex, CHECK_BATCH, f32, dev, 3))
        t0 = time.perf_counter()
        want = fs.fused_step_reference(fm, small, dt, iters=iters, compensated=True)
        torch.cuda.synchronize()
        log(f"{case}: the plain version's step on {CHECK_BATCH} members took "
            f"{time.perf_counter() - t0:.2f} s")
        for name in routes:
            got = route(name, small, 1)
            torch.cuda.synchronize()
            worst, errs, failures = cs.compare_states(got, want, "float32")
            rec["max_err"][name] = worst
            log(f"{case}: {name} vs plain, {CHECK_BATCH} members, one step: bitwise "
                f"{torch.equal(got, want)}, " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                + (" FAILED: " + "; ".join(failures) if failures else ""))
            if failures:
                raise AssertionError(f"{case}: {name} kernel disagrees with its plain version")
        state = stepper.init(cs.jittered_phase(ex, BATCH, f32, dev, 0))
        est, _ = time_queued(lambda: route(routes[0], state, SPC), 3)
        reps = max(10, min(100, round(300 / max(est, 1e-3))))
        for r in range(args.pairs):
            order = routes[r % len(routes):] + routes[:r % len(routes)]
            for name in order:
                t, _ = time_queued(lambda: route(name, state, SPC), reps)
                rec["ms"][name].append(t)
            log(f"{case}: round {r}: " + ", ".join(f"{k} {v[-1]:.4f} ms"
                                                   for k, v in rec["ms"].items())
                + f" ({reps} launches a window)")
        rec["median_ms"] = {k: statistics.median(v) for k, v in rec["ms"].items()}
        log(f"{case}: medians " + ", ".join(f"{k} {v:.4f} ms"
                                            for k, v in rec["median_ms"].items()))
    log(json.dumps({"card": card, "builds": builds, "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
