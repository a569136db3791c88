#!/usr/bin/env python3
"""Every hand-written kernel once on one card at a small size, held against
its plain PyTorch version: the workload for ``compute-sanitizer``.

    python3 scripts/sanitize_kernels.py [--only SOURCE]
    python3 scripts/sanitize_kernels.py --sanitize memcheck,racecheck,synccheck,initcheck
                                        [--only SOURCE[,SOURCE...]] [--timeout SECONDS]

SOURCE is a ``csrc/<SOURCE>.cu`` of ``hamilton_tpu_torch``: ``fused_step``,
``chain_variants``, ``family_step``, ``semisep_wide``, ``user_family_step``,
``batched_spd``, ``roofline_probes``, ``libm_check`` (all by default).  The
kernels are the shipped builds: ``kernels.build_all()`` (and
``kernels.build_user_family`` for the generated kernel) with the flags of
``kernels/__init__.py``, never a build with other flags.

What each source runs (each K1 launch 2 steps, on 7, 37 and 300 members: a
partial warp and a partial block, the lanes of a member at a block's tail
among them; the plain version runs once on the 300 and is sliced):

- ``fused_step``: every variant of ``kernels.FUSED_STEP_VARIANTS`` (the
  semiseparable chain at n = 20 and 5, the dense chain at n = 2, and on G
  lanes a member at n = 20 and 40), float32 and float64, a shared and a
  per-member table, Kahan (2,0) and Suzuki-composed (2,1);
- ``chain_variants``: Möbius at n = 20 and 5, L⁻¹ at n = 20 (4 lanes) and
  n = 5 (2 lanes), the dense chain at n = 4, in those modes;
- ``family_step``: the six families (Bézier at 5 and 2 points);
- ``semisep_wide``: the semiseparable chain at n = 40 (float32 on 2 lanes,
  float64 on 4);
- ``user_family_step``: the elastic pendulum's generated header, on its
  float64 constant table, a run-time shared table and a per-member one;
- ``batched_spd``: K2a-K2e at n = 3, 20 and 32 (one thread, 4 lanes and
  8 lanes a member, by entry and dtype), float32, float64 and bfloat16, on
  7, 37 and 300 members (√M·J at m = 2n);
- ``roofline_probes``: K3a-K3c on a few thousand floats, partial blocks;
- ``libm_check``: the straight-line sin/cos, sqrt and reciprocal against
  the library on every float.

A K1 launch must be bit for bit its plain version where its build has no
FMA contraction, else within float64 1e-11 or float32 1e-4 (``vdot_est``
compared as dt·vdot_est), as ``tests/test_torch_kernel.py`` holds them; K2
and K3a, K3c bit for bit, K3b (one rep) bit for bit; ``libm_check`` no float
differing.  A line a launch, a last line of JSON ``{"card": ..., "sources":
{source: {"launches": n, "failures": [...]}}}``; exit 1 on a failure.

``--sanitize TOOLS`` builds first, without a tool, then runs this script
once a source and tool under the toolkit's ``compute-sanitizer`` (beside
``nvcc``, ``kernels._nvcc()``) with ``--error-exitcode 9``, each run's log
in ``chiprun_out/sanitize/<tool>-<source>.log``, and prints a line per run
(its exit code, the tool's summary line, whether the tool refused the card)
and a last line of JSON ``{"card": ..., "sanitizer": version, "runs":
[{"tool", "source", "rc", "summary", "seconds"}]}``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "chiprun_out" / "sanitize"
SOURCES = ("fused_step", "chain_variants", "family_step", "semisep_wide", "user_family_step",
           "batched_spd", "roofline_probes", "libm_check")
BATCHES = (7, 37, 300)
STEPS = 2
K2_SIZES = (3, 20, 32)
TOL = {"float64": 1e-11, "float32": 1e-4}

def _example(factory, *args, **kw):
    def make(dev, dtype):
        ex = factory(*args, device=dev, dtype=dtype, **kw)
        return ex.system, ex.init_phase.q.cpu().double().numpy()
    return make


def _elastic(dev, dtype):
    from hamilton_tpu_torch.examples import elastic_pendulum
    return elastic_pendulum.make_system(device=dev, dtype=dtype), [0.3, 1.1]


def _k1_cases():
    """Every K1 case: ``(label, source, factory(dev, dtype) -> (system, q
    centre), dt)``."""
    import hamilton_tpu_torch as tp

    cases = [(f"chain n={n} {solver}", source,
              _example(tp.chain, n_links=n, fused_solver=solver), 5e-4)
             for n, solver, source in (
                 (20, "semiseparable", "fused_step"), (5, "semiseparable", "fused_step"),
                 (2, "dense", "fused_step"), (40, "dense", "fused_step"),
                 (20, "dense", "fused_step"), (20, "mobius", "chain_variants"),
                 (5, "mobius", "chain_variants"), (20, "linv", "chain_variants"),
                 (5, "linv", "chain_variants"), (4, "dense", "chain_variants"),
                 (40, "semiseparable", "semisep_wide"))]
    cases += [(name, "family_step", _example(factory), 1e-3) for name, factory in (
        ("spherical", tp.spherical_pendulum), ("two_body", tp.two_body), ("room", tp.room),
        ("spring", tp.spring), ("ellipse", tp.ellipse), ("bezier 5 points", tp.bezier))]
    cases.append(("bezier 2 points", "family_step",
                  _example(tp.bezier, [(-1.0, -1.0), (1.0, 1.0)]), 1e-3))
    cases.append(("elastic pendulum", "user_family_step", _elastic, 1e-3))
    return cases


#: the sources whose every build runs without FMA contraction (and the
#: fused_step parts that do: the dense chain on lanes)
BITWISE = ("chain_variants", "family_step", "semisep_wide", "user_family_step")


def log(msg: str) -> None:
    print(msg, flush=True)


def _bitwise_k1(source, n, solver) -> bool:
    return source in BITWISE or (source == "fused_step" and solver == "dense" and n >= 20)


def _k1_modes(system, batch, rng, dev, dtype, generated):
    """``{table mode: system}``: the shared table, and a per-member one
    (every parameter times 1 + 0.01·N(0, 1) a member); the ``generated``
    kernel on the float64 constant table, a run-time shared table and a
    per-member one."""
    import torch

    if not system.params:  # room: no parameters, no per-member table
        return {"shared": system}
    swept = system.replace_params({
        k: v.expand(batch, *v.shape) * torch.as_tensor(
            1.0 + 0.01 * rng.standard_normal((batch,) + (1,) * v.ndim), device=dev, dtype=dtype)
        for k, v in system.params.items()})
    modes = {"shared": system, "per-member": swept}
    if generated:
        modes = {"constant": system,
                 "shared": system.replace_params(
                     {k: v.clone().requires_grad_(True) for k, v in system.params.items()}),
                 "per-member": swept}
    return modes


def run_k1(source, dev, record) -> None:
    import numpy as np
    import torch

    import hamilton_tpu_torch as tp
    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.ops import fused_step as fs

    launcher = "user_family" if source == "user_family_step" else source
    big = max(BATCHES)
    for label, case_source, make, dt in _k1_cases():
        if case_source != source:
            continue
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[-1]
            rng = np.random.default_rng(19)
            system, centre = make(dev, dtype)
            modes = _k1_modes(system, big, rng, dev, dtype, source == "user_family_step")
            for mode, msys in modes.items():
                forms = msys.fused_forms(msys)
                n = forms.n
                q = np.asarray(centre) + 0.01 * rng.standard_normal((big, n))
                p = 0.05 * rng.standard_normal((big, n))
                for kind, iters, comp, composition in (
                        ("kahan (2,0)", (2, 0), True, (1.0,)),
                        ("suzuki4 (2,1)", (2, 1), False, fs.SUZUKI4_COMPOSITION)):
                    st = fs.fused_stepper(forms, iters=iters, compensated=comp,
                                          composition=composition)
                    carry = st.init(tp.phase_from_numpy(q, p, device=dev, dtype=dtype))
                    state, table = carry if isinstance(carry, tuple) else (carry, None)
                    state = state.detach()
                    table = None if table is None else table.detach()
                    kw = dict(iters=iters, compensated=comp, steps_per_call=STEPS,
                              composition=composition)
                    want = fs.fused_step_reference(forms, state, dt, coef=table, **kw)
                    for b in BATCHES:
                        sub = table if table is None or table.ndim == 1 else table[:, :b]
                        before = kernels.LAUNCHERS[launcher].launches
                        got = fs.fused_step_kernel(forms, state[..., :b].contiguous(), dt,
                                                   coef=None if sub is None
                                                   else sub.contiguous(), **kw)
                        torch.cuda.synchronize()
                        launched = kernels.LAUNCHERS[launcher].launches - before
                        ref = want[..., :b]
                        scale = torch.ones(state.shape[0], 1, 1, dtype=torch.float64,
                                           device=dev)
                        scale[-1] = dt
                        err = float(((got.double() - ref.double()) * scale).abs().max())
                        equal = bool(torch.equal(got, ref))
                        solver = label.split()[-1]
                        need_equal = _bitwise_k1(source, n, solver)
                        ok = (launched == 1 and bool(torch.isfinite(got).all())
                              and err <= TOL[dname] and (equal or not need_equal))
                        _record(record, source, f"{label} {dname} {mode} {kind} B={b}", ok,
                                f"bitwise {equal}{' (required)' if need_equal else ''}, "
                                f"max |scaled diff| {err:.3e}, {launched} launch")


def _record(record, source, what, ok, detail) -> None:
    rec = record.setdefault(source, {"launches": 0, "failures": []})
    rec["launches"] += 1
    if not ok:
        rec["failures"].append(what)
    log(f"{source}: {what}: {'ok' if ok else 'FAILED'} ({detail})")


def run_k2(dev, record) -> None:
    import torch

    import chip_smoke as cs
    from hamilton_tpu_torch.ops import batched_spd as bs

    big = max(BATCHES)
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for n in K2_SIZES:
            k, js, b = cs.k2_inputs(big, n, dtype, dev, seed=n)
            for entry in bs.ENTRIES:
                args = cs.k2_args(entry, k, js, b)
                want = entry.plain(*args)
                for nb in BATCHES:
                    sub = [a[:nb].contiguous() for a in args]
                    before = entry.launch.launches
                    got = entry.kernel(*sub)
                    torch.cuda.synchronize()
                    launched = entry.launch.launches - before
                    ref = want[:nb]
                    same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
                    ok = launched == 1 and bool(same.all())
                    _record(record, "batched_spd", f"{entry.name} {dname} n={n} B={nb}", ok,
                            f"bitwise {bool(same.all())}, {launched} launch, "
                            f"{int(torch.isnan(ref).any(-1).sum()) if ref.ndim > 1 else 0} "
                            f"members NaN in the plain version")


def run_k3(dev, record) -> None:
    import torch

    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.utils import roofline as rl

    g = torch.Generator().manual_seed(5)
    for chains, block in ((1, 128), (8, 256), (32, 64)):
        x = (1.0 + torch.rand(32 * 75, generator=g)).to(dev)  # 2400: partial blocks
        for name, probe, plain, reps in (("fma", rl.fma_chain, rl.fma_chain_plain, 40),
                                         ("sin", rl.sin_chain, rl.sin_chain_plain, 1)):
            launcher = kernels.fma_probe_launch if name == "fma" else kernels.sin_probe_launch
            before = launcher.launches
            got = probe(x, reps, chains=chains, block=block)
            torch.cuda.synchronize()
            ok = launcher.launches == before + 1 and torch.equal(got, plain(x, reps))
            _record(record, "roofline_probes", f"{name}_probe chains={chains} block={block} "
                    f"{x.numel()} floats", ok, f"bitwise {bool(torch.equal(got, plain(x, reps)))}")
    a = torch.randn(4 * 3001, generator=g).to(dev)
    for blocks in (1, 3, 4096):
        before = kernels.add_one_launch.launches
        got = rl.add_one(a, blocks=blocks)
        torch.cuda.synchronize()
        ok = kernels.add_one_launch.launches == before + 1 and torch.equal(got, a + 1.0)
        _record(record, "roofline_probes", f"add_one blocks={blocks} {a.numel()} floats", ok,
                f"bitwise {bool(torch.equal(got, a + 1.0))}")


def run_libm(record) -> None:
    from hamilton_tpu_torch import kernels

    counts = kernels.libm_mismatches()
    _record(record, "libm_check", "every float in each function's range", not any(
        counts.values()), f"floats differing {counts}")


def build(sources, dev) -> None:
    """The shipped builds of ``sources`` (the generated kernel's header from
    the elastic pendulum's forms)."""
    import torch

    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.ops import fused_codegen

    t0 = time.perf_counter()
    names = [s for s in sources if s != "user_family_step"]
    if set(names) == set(SOURCES) - {"user_family_step"}:
        kernels.build_all()
    else:
        for name in names:
            kernels.build(name)
    if "user_family_step" in sources:
        for dtype in (torch.float32, torch.float64):
            system, _ = _elastic(dev, dtype)
            kernels.build_user_family(fused_codegen.generated(system.fused_forms(system)).header)
    log(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(sources)}")


def drive(sources) -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("sanitize_kernels: needs a CUDA device")
    dev = torch.device("cuda", 0)
    log(f"card: {cs.card_line()}")
    build(sources, dev)
    record = {}
    for source in sources:
        t0 = time.perf_counter()
        if source == "batched_spd":
            run_k2(dev, record)
        elif source == "roofline_probes":
            run_k3(dev, record)
        elif source == "libm_check":
            run_libm(record)
        else:
            run_k1(source, dev, record)
        log(f"{source}: {record.get(source, {}).get('launches', 0)} launches checked in "
            f"{time.perf_counter() - t0:.1f} s")
    log(json.dumps({"card": cs.card_line(), "sources": record}))
    return 1 if any(r["failures"] for r in record.values()) else 0


def sanitize(tools, sources, timeout) -> int:
    """Each source under each tool in a process of its own."""
    import chip_smoke as cs
    from hamilton_tpu_torch import kernels

    tool = Path(kernels._nvcc()).parent / "compute-sanitizer"
    if not tool.exists():
        raise SystemExit(f"sanitize_kernels: no compute-sanitizer beside nvcc ({tool})")
    version = subprocess.run([str(tool), "--version"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()[-1]
    card = cs.card_line()
    log(f"card: {card}; {version}")
    rc = subprocess.run([sys.executable, __file__, "--build-only", "--only", ",".join(sources)],
                        timeout=timeout).returncode
    if rc != 0:
        raise SystemExit(f"sanitize_kernels: the build failed ({rc})")
    OUT.mkdir(parents=True, exist_ok=True)
    runs = []
    for name in tools:
        for source in sources:
            path = OUT / f"{name}-{source}.log"
            cmd = [str(tool), "--tool", name, "--error-exitcode", "9", "--print-limit", "200",
                   sys.executable, __file__, "--only", source]
            t0 = time.perf_counter()
            with open(path, "w") as f:
                try:
                    rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                                        timeout=timeout).returncode
                except subprocess.TimeoutExpired:
                    rc = "timeout"
            text = path.read_text()
            summary = re.findall(r"=+ ((?:ERROR|RACECHECK|LEAK) SUMMARY: .*)", text)
            refused = "Device not supported" in text
            run = {"tool": name, "source": source, "rc": rc, "summary": summary,
                   "device_not_supported": refused,
                   "checked": len(re.findall(r": ok \(", text)),
                   "seconds": round(time.perf_counter() - t0, 1)}
            runs.append(run)
            log(f"{name} {source}: rc {rc}, {run['checked']} launches checked, "
                f"{'; '.join(summary) or 'no summary'}"
                + ("; the tool reported 'Device not supported'" if refused else "")
                + f" ({run['seconds']} s; {path.relative_to(REPO)})")
    log(json.dumps({"card": card, "sanitizer": version, "runs": runs}))
    return 0


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(SOURCES))
    ap.add_argument("--sanitize", default="")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    sources = [s for s in args.only.split(",") if s]
    unknown = set(sources) - set(SOURCES)
    if unknown:
        raise SystemExit(f"sanitize_kernels: no source {sorted(unknown)}; sources {SOURCES}")
    sys.path.insert(0, str(REPO))
    if args.sanitize:
        return sanitize([t for t in args.sanitize.split(",") if t], sources, args.timeout)
    if args.build_only:
        import torch
        build(sources, torch.device("cuda", 0))
        return 0
    return drive(sources)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
