#!/usr/bin/env python3
"""Where a K1 launch spends its cycles, by phase of the step, on one card.

    python3 scripts/k1_phases.py [--tree DIR] [--sass] [FORM ...]

FORM is a chain form, ``semiseparable`` (default; ``csrc/fused_step.cu``'s
one-thread template: the copy's link split at n = 20 switched off,
``kWide20LanesF = 0``, so not with ``semiseparable20`` in one call) or
``mobius`` (``csrc/chain_variants.cu``); a family of ``csrc/family_step.cu``,
``spherical``, ``two_body``, ``room``, ``spring``, ``ellipse``, ``bezier5`` or
``bezier2``; or a family on the generated kernel (``csrc/user_family_step.cu``
around the header ``ops/fused_codegen.py`` prints), ``bezier3`` or
``elastic``; or the dense chain on one thread a member, ``dense2`` (the
double pendulum, ``csrc/fused_step.cu``) or ``dense4`` (``fit_masses``'
chain, ``csrc/chain_variants.cu`` case 4).  All run on the one-thread
template ``step_member`` (``csrc/fused_step.cuh``), but ``dense20`` and
``dense40``: the dense chain
on G lanes a member (``csrc/dense_lanes.cuh``), on the lane template
``lane_step`` (``csrc/chain_lanes.cuh``), whose calls of the forms' routines
are wrapped alike, and whose solve's back half (the dependent chain of
``dense_back_lanes``) is timed on its own; ``linv20``: the chain's L⁻¹
form on its lanes (``csrc/chain_variants.cu`` case 2, ``lane_step``
likewise), whose factor's generator recursion (``lane_generators``, run out
of line inside the factor) is timed on its own; and ``semiseparable40`` and
``semiseparable20``: the semiseparable chain on its link split
(``csrc/semisep_wide.cuh``, G lanes a member: at n = 40 through
``csrc/semisep_wide.cu``, its vectors in shared memory; at n = 20 through
``csrc/fused_step.cu``, its vectors in registers), whose ``wide_step``'s
calls of its routines are wrapped alike (the aux's shift to q1,
``wide_q1_update`` and ``wide_settle``, read as aux_at), and whose named
barriers' waits, where a lane waits for another's scan, are timed on their
own (the hand-off).  The script copies DIR's package (default: this
checkout's; DIR may be a parent unpacked with ``git archive`` into
``_archive/parent``) to ``hamilton_tpu_torch/_build/k1_phases/<DIR's
name>/``, wraps each of ``step_member``'s calls of the policy's ``aux``,
``aux_at``, ``factor``, ``solve`` and ``dhdq`` in the copy with
``clock64()`` reads summed in registers, and the whole of ``step_member``
likewise (lane 0 of each warp adds its sums to device counters once, as
``step_member`` ends: an atomic at every phase call serializes the warps of
a short step), builds the form's float32 kernel and runs one launch:

- the chain forms: the headline configuration (16384 members, Kahan (2,0),
  dt = 5e-4, 50 steps, shared table, n = 20);
- the families and ``bezier3``: ``chip_smoke.py`` phase 15 (e)'s and phase
  18 (e)'s row, 16384 members, Kahan (2,0), 50 steps, each family's dt;
- ``elastic``: phase 18 (f)'s row, the example's sweep of 16384 members
  with per-member tables, (2,1), one step a launch, dt = 5e-3;
- ``dense2``: ``chip_smoke.py`` phase 4's row (16384 members, (2,1),
  dt = 1e-3, 50 steps, shared table); ``dense4``: ``fit_masses --fused``'
  launch (1024 members, (3,1), dt = 1e-2, 24 steps, shared table); both
  float32 without Kahan, read as aux, aux shift, factor, solves and dH/dq;
- ``dense20`` and ``dense40``: ``chip_smoke.py`` phase 21 (a)'s rows
  (16384 members, Kahan, 50 steps, shared table; (2,1) at dt = 1e-3 and
  (2,0) at dt = 5e-4), read as aux (and its shift), K and factor, forward
  solves, back-solve chain and dH/dq;
- ``linv20``: phase 16 (e)'s n = 20 row, the headline's configuration on
  the L⁻¹ form (16384 members, Kahan (2,0), dt = 5e-4, 50 steps, shared
  table), read as aux (and its shift), generators, columns of L⁻¹, solves
  and dH/dq;
- ``semiseparable40``: phase 21 (a)'s semiseparable row (16384 members,
  Kahan (2,0), dt = 5e-4, 50 steps, shared table), and ``semiseparable20``
  the headline's (the same at n = 20), read as aux, aux shift, factor,
  solves, dH/dq and the hand-off (the barrier waits: how far the lanes
  overlap).

The package itself is not touched.  ``--sass`` also builds DIR's own
(unprobed) ``family_step.cu`` and writes ``cuobjdump -sass`` of each family
FORM's float32 Kahan shared-table and per-member instantiations to
``chiprun_out/k1_sass_<FORM>.txt``, printing how many shared (``LDS``),
global (``LDG``) and local (``LDL``) loads, calls, branches and ``MUFU``
operations each holds; for ``dense2`` and ``dense4`` the parts of
``fused_step.cu`` and ``chain_variants.cu`` that hold them, the
instantiation each row runs (``dense2`` also ``chaos_scan``'s, per-member
tables at (3,1)), with the same counts inside the step loop (between the
outermost backward branch and its target) beside the whole kernel's; for
``linv20`` the part of ``chain_variants.cu`` that holds it, the counts in
the lane kernel's step loop (the aux inlined there) and in its out-of-line
factor (the generators and the columns: the routine it calls first, up to
the next routine a call enters).

Prints the card's name and power limit and, per form, the cycles a warp
spends a step in each phase (on lanes, lane 0's of each warp: the lanes of a
member wait for each other at every exchange), their shares of the step, and
the probed launch's device ms (the reads cost time: compare shares, not
times, with an unprobed kernel); a last line of JSON.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / "hamilton_tpu_torch" / "_build" / "k1_phases"
PHASES = ("aux", "aux_at", "factor", "solve", "dhdq")
BATCH, SPC = 16384, 50
CHAINS = {"semiseparable": ("fused_step", 20), "mobius": ("chain_variants", 0)}
# the families of csrc/family_step.cu: (family code, chip_smoke.py phase 15's
# jitter scale, dt)
FAMILIES = {"spherical": (0, 0.05, 2.5e-4), "two_body": (1, 0.02, 2.5e-4),
            "room": (2, 0.05, 2.5e-4), "spring": (3, 0.02, 1e-3),
            "ellipse": (4, 0.05, 2.5e-4), "bezier5": (5, 0.05, 2.5e-4),
            "bezier2": (6, 0.05, 2.5e-4)}
GENERATED = ("bezier3", "elastic")
# the dense chain on lanes: (n, iters, dt)
LANE_FORMS = {"dense20": (20, (2, 1), 1e-3), "dense40": (40, (2, 0), 5e-4)}
# the chain's L^-1 form on its lanes: (chain_variants' code, n, iters, dt)
LINV_FORMS = {"linv20": (2, 20, (2, 0), 5e-4)}
# the instantiation --sass reads of it: lane_kernel<float, 20, G, Kahan,
# shared, not composed, the L^-1 form>
LINV_SASS = ("lane_kernelIfLi20ELi", "ELb1ELb0ELb0ELi0E")
SOURCES = ("fused_step", "chain_variants", "family_step", "user_family_step", "semisep_wide")
# the semiseparable chain on its link split (csrc/semisep_wide.cuh): (its
# source, n, iters, dt)
WIDE_FORMS = {"semiseparable40": ("semisep_wide", 40, (2, 0), 5e-4),
              "semiseparable20": ("fused_step", 20, (2, 0), 5e-4)}
# the dense chain on one thread a member: (n, source, its code, members,
# iters, dt, steps a launch)
DENSE_FORMS = {"dense2": (2, "fused_step", 2, 16384, (2, 1), 1e-3, 50),
               "dense4": (4, "chain_variants", 4, 1024, (3, 1), 1e-2, 24)}
# the instantiations --sass reads of each, (label, mangled name up to its
# modes, iters): fused_step_kernel<float, 2, dense, no Kahan, per-member,
# not composed> and chain_variant_kernel<float, 4, no Kahan, shared, not
# composed>
DENSE_SASS = {"dense2": (("shared (2,1)", "fused_step_kernelIfLi2ELb0ELb0ELb0ELb0E", (2, 1)),
                         ("per-member (3,1)", "fused_step_kernelIfLi2ELb0ELb0ELb1ELb0E",
                          (3, 1))),
              "dense4": (("shared (3,1)", "chain_variant_kernelIfLi4ELb0ELb0ELb0E", (3, 1)),)}

PROBE = """
__device__ unsigned long long g_phase_cycles[8];
__device__ __forceinline__ long long phase_clock() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}
// A thread's cycles by phase (5: the whole of the step, 6: the dense lane
// solves' back halves), in registers; lane 0 of each warp adds them to the
// device counters once, as the step ends.  (7: L^-1's generators, which
// run inside its out-of-line factor: lane 0 of each warp adds each call's.)
struct PhaseCycles {
  long long c[7] = {0, 0, 0, 0, 0, 0, 0};
  long long t0;
  __device__ PhaseCycles() { t0 = phase_clock(); }
  __device__ ~PhaseCycles() {
    c[5] = phase_clock() - t0;
    if ((threadIdx.x & 31) == 0)
      for (int k = 0; k < 7; ++k) atomicAdd(&g_phase_cycles[k], (unsigned long long)c[k]);
  }
};
struct PhaseClock {
  long long& acc;
  long long t0;
  __device__ explicit PhaseClock(long long& a) : acc(a) { t0 = phase_clock(); }
  __device__ ~PhaseClock() { acc += phase_clock() - t0; }
};
"""
ENTRIES = """
extern "C" int hamilton_phase_cycles(unsigned long long* out, int zero) {
  if (zero) {
    unsigned long long z[8] = {0};
    return (int)cudaMemcpyToSymbol(g_phase_cycles, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(unsigned long long) * 8);
}
"""
# the SASS opcodes --sass counts in an instantiation
SASS_OPS = ("LDS", "LDG", "LDL", "CALL", "BRA", "MUFU")


def _copy(tree: Path, one_thread: bool = False) -> Path:
    """The tree's package copied with the probes; ``one_thread``: its
    semiseparable chain at n = 20 on the one-thread template (where the
    tree routes it to the link split)."""
    where = WORK / tree.resolve().name
    pkg = where / "hamilton_tpu_torch"
    if pkg.exists():  # its builds, named by a hash of what they were built from, stay
        for child in pkg.iterdir():
            if child.name != "_build":
                shutil.rmtree(child) if child.is_dir() else child.unlink()
    shutil.copytree(tree / "hamilton_tpu_torch", pkg, dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    header = pkg / "csrc" / "fused_step.cuh"
    text = header.read_text().replace("namespace {\n", "namespace {\n" + PROBE, 1)
    count = 0
    for k, phase in enumerate(PHASES):
        text, n = re.subn(rf"(P::{phase}\([^;]*\);)",
                          rf"{{ PhaseClock clock_(phase_cycles_.c[{k}]); \1 }}", text)
        count += n
    text, n = re.subn(r"(  typename P::Aux ax;[^\n]*\n)", r"\1  PhaseCycles phase_cycles_;\n",
                      text)
    if count < 10 or n != 1:
        raise RuntimeError(f"{header}: {count} phase calls and {n} step clocks wrapped")
    header.write_text(text)
    _wrap_lanes(pkg / "csrc")
    wide_header = pkg / "csrc" / "semisep_wide.cuh"
    _wrap_wide(wide_header if wide_header.exists() else pkg / "csrc" / "semisep_wide.cu")
    if one_thread:
        k1 = pkg / "csrc" / "fused_step.cu"
        k1.write_text(re.sub(r"\bkWide20LanesF = \d+", "kWide20LanesF = 0", k1.read_text()))
    for source in SOURCES:
        src = pkg / "csrc" / f"{source}.cu"
        src.write_text(src.read_text() + ENTRIES)
    return where


def _wrap_lanes(csrc: Path) -> None:
    """The lane step's probes: ``lane_step``'s calls of its forms' routines
    wrapped as ``step_member``'s, and the dense solve's back half timed into
    the forms' ``back_cycles``, read into phase 6 as the step ends."""
    lanes = csrc / "chain_lanes.cuh"
    text = lanes.read_text()
    count = 0
    for k, phase in enumerate(PHASES):
        text, n = re.subn(rf"(forms\.{phase}\([^;]*\);)",
                          rf"{{ PhaseClock clock_(phase_cycles_.c[{k}]); \1 }}", text)
        count += n
    edits = [("  const int g = Sh::lane();\n  auto link = [g](int j)",
              "  PhaseCycles phase_cycles_;\n"
              "  const int g = Sh::lane();\n  auto link = [g](int j)"),
             ("#pragma unroll\n  for (int j = 0; j < J; ++j) {\n    if (!mine(j)) continue;",
              "  phase_cycles_.c[6] = forms.back_cycles;\n#pragma unroll\n"
              "  for (int j = 0; j < J; ++j) {\n    if (!mine(j)) continue;"),
             ("    lane_generators<Sh>(cf);\n",
              "    const long long t0_ = phase_clock();\n    lane_generators<Sh>(cf);\n"
              "    if ((threadIdx.x & 31) == 0)\n"
              "      atomicAdd(&g_phase_cycles[7], (unsigned long long)(phase_clock() - t0_));\n")]
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{lanes}: {old!r} not found once")
        text = text.replace(old, new)
    # the lane aux's template argument differs between trees
    text, n = re.subn(r"(struct LinvLaneForms : LaneTrig<Sh, [^>]*> \{\n)",
                      r"\1  long long back_cycles = 0;\n", text)
    if n != 1:
        raise RuntimeError(f"{lanes}: LinvLaneForms not found once")
    if count != 18:
        raise RuntimeError(f"{lanes}: {count} of lane_step's 18 routine calls wrapped")
    lanes.write_text(text)
    dense = csrc / "dense_lanes.cuh"
    text = dense.read_text()
    for old, new in (("  T x[J];  // the last solve's x at this lane's rows\n",
                      "  T x[J];  // the last solve's x at this lane's rows\n"
                      "  long long back_cycles = 0;\n"),
                     ("    dense_back_lanes<Sh>(y, x);\n",
                      "    { const long long t0_ = phase_clock(); dense_back_lanes<Sh>(y, x); "
                      "back_cycles += phase_clock() - t0_; }\n")):
        if text.count(old) != 1:
            raise RuntimeError(f"{dense}: {old!r} not found once")
        text = text.replace(old, new)
    dense.write_text(text)


def _wrap_wide(src: Path) -> None:
    """The link split's probes (``semisep_wide.cuh``, or a tree's
    ``semisep_wide.cu`` before it): ``wide_step``'s calls of its routines
    wrapped as ``step_member``'s (the trig into aux, the shift to q1 into
    aux_at), the whole step likewise, and each named barrier's wait summed
    in the member's ``waited``, read into phase 6 as the step ends."""
    text = src.read_text()
    head, rest = text.split("__device__ __forceinline__ void wide_step(", 1)
    anchor = ("// ---- the kernel, its launch and its layout" if src.suffix == ".cuh"
              else "template <typename T>\nstruct WideLanes")
    body, tail = rest.split(anchor, 1)
    count = 0
    for k, pattern in ((0, r"wide_trig\("), (1, r"wide_q1_update\(|wide_settle\("),
                       (2, r"wide_factor\("), (3, r"wide_solve\("), (4, r"wide_dhdq<\w+>\(")):
        body, n = re.subn(rf"((?:{pattern})[^;]*;)",
                          rf"{{ PhaseClock clock_(phase_cycles_.c[{k}]); \1 }}", body)
        count += n
    body, n = re.subn(r"(  const int lo = m\.lo\(\);\n(?:  const WideTable[^\n]*\n)?)",
                      r"\1  PhaseCycles phase_cycles_;\n", body, count=1)
    if n != 1:
        raise RuntimeError(f"{src}: wide_step's first line not found")
    edits = [("  if (!active) return;\n",
              "  phase_cycles_.c[6] = m.waited;\n  if (!active) return;\n")]
    for old, new in edits:
        if body.count(old) != 1:
            raise RuntimeError(f"{src}: {old!r} not found once in wide_step")
        body = body.replace(old, new)
    if count != 20:
        raise RuntimeError(f"{src}: {count} of wide_step's 20 routine calls wrapped")
    head, n = re.subn(r"(  int g; +// its lane\n)", r"\1  mutable long long waited = 0;\n", head)
    if n != 1:
        raise RuntimeError(f"{src}: the member's lane not found once")
    for old, new in (("#ifdef __CUDA_ARCH__\n      asm volatile(\"bar.sync",
                      "#ifdef __CUDA_ARCH__\n      const long long t0_ = phase_clock();\n"
                      "      asm volatile(\"bar.sync"),
                     ("                   : \"memory\");\n",
                      "                   : \"memory\");\n      waited += phase_clock() - t0_;\n")):
        if head.count(old) != 1:
            raise RuntimeError(f"{src}: {old!r} not found once")
        head = head.replace(old, new)
    src.write_text(head + "__device__ __forceinline__ void wide_step(" + body + anchor + tail)


def _launch(form, dev):
    """``(library path, a launch of the form's row, steps a launch,
    members)``, building what the form needs."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import hamilton_tpu_torch as tp
    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.ops import fused_codegen
    from hamilton_tpu_torch.ops.fused_step import coef_table, fused_step_kernel, fused_stepper

    f32, f64 = torch.float32, torch.float64
    rng = np.random.default_rng(16)
    if form in DENSE_FORMS:
        n, source, code, batch, iters, dt, spc = DENSE_FORMS[form]
        lib = kernels.build(source, parts=(kernels.PARTS[source][1](0, code, False),)).paths[0]
        if n == 2:  # phase 4's members
            ex = tp.double_pendulum(device=dev, dtype=f32)
            ph = cs.jittered_phase(ex, batch, f32, dev, 1)
        else:  # fit_masses --fused' launch
            ex = tp.chain(n_links=n, device=dev, dtype=f32)
            ph = tp.Phase(ex.init_phase.q.expand(batch, n).contiguous(),
                          torch.tensor([0.8, -0.3, 0.5, -0.2], dtype=f32,
                                       device=dev).expand(batch, n).contiguous())
        forms = ex.system.fused_forms(ex.system)
        state = fused_stepper(forms, iters=iters).init(ph)
        kw = dict(iters=iters, compensated=False, steps_per_call=spc,
                  coef=coef_table(forms, dev, f32))
        return lib, lambda: fused_step_kernel(forms, state, dt, **kw), spc, batch
    if form in WIDE_FORMS:
        source, n, iters, dt = WIDE_FORMS[form]
        lib = kernels.build(source, parts=(kernels.PARTS[source][1](0, n, True),)).paths[0]
        ex = tp.chain(n_links=n, fused_solver="semiseparable", device=dev, dtype=f32)
        forms = ex.system.fused_forms(ex.system)
        state = fused_stepper(forms, iters=iters, compensated=True).init(
            cs.jittered_phase(ex, BATCH, f32, dev, 0))
        coef = coef_table(forms, dev, f32)

        def wide():  # the kernel itself, whatever KERNEL_INSTANTIATIONS routes
            out = torch.empty_like(state)
            kernels.LAUNCHERS[source](
                dtype_code=0, code=n, semiseparable=True, compensated=True,
                per_member=False, coef=coef.data_ptr(), state_in=state.data_ptr(),
                state_out=out.data_ptr(), batch=BATCH, dt=dt, iters_p=iters[0],
                iters_q=iters[1], steps_per_call=SPC, weights=(1.0,),
                stream=torch.cuda.current_stream(dev).cuda_stream)
            return out

        return lib, wide, SPC, BATCH
    if form in LANE_FORMS:
        n, iters, dt = LANE_FORMS[form]
        part = kernels.PARTS["fused_step"][1](0, n, False)
        lib = kernels.build("fused_step", parts=(part,)).paths[0]
        ex = tp.chain(n_links=n, fused_solver="dense", device=dev, dtype=f32)
        forms = ex.system.fused_forms(ex.system)
        state = fused_stepper(forms, iters=iters, compensated=True).init(
            cs.jittered_phase(ex, BATCH, f32, dev, 0))
        kw = dict(iters=iters, compensated=True, steps_per_call=SPC,
                  coef=coef_table(forms, dev, f32))
        return lib, lambda: fused_step_kernel(forms, state, dt, **kw), SPC, BATCH
    if form in LINV_FORMS:
        code, n, iters, dt = LINV_FORMS[form]
        lib = kernels.build("chain_variants",
                            parts=(kernels.PARTS["chain_variants"][1](0, code, False),)).paths[0]
        ex = tp.chain(n_links=n, fused_solver="linv", device=dev, dtype=f32)
        forms = ex.system.fused_forms(ex.system)
        state = fused_stepper(forms, iters=iters, compensated=True).init(
            cs.jittered_phase(ex, BATCH, f32, dev, 0))
        kw = dict(iters=iters, compensated=True, steps_per_call=SPC,
                  coef=coef_table(forms, dev, f32))
        return lib, lambda: fused_step_kernel(forms, state, dt, **kw), SPC, BATCH
    if form in CHAINS:
        source, code = CHAINS[form]
        lib = kernels.build(source, parts=(kernels.PARTS[source][1](0, code, form == "semiseparable"),)).paths[0]
        ex = tp.chain(n_links=20, fused_solver=form, device=dev, dtype=f32)
        forms = ex.system.fused_forms(ex.system)
        q = ex.init_phase.q.cpu().numpy() + 0.01 * rng.standard_normal((BATCH, 20))
        ph = tp.Phase(torch.tensor(q, dtype=f32, device=dev),
                      ex.init_phase.p.to(f32).expand(BATCH, 20).contiguous())
        state = fused_stepper(forms, iters=(2, 0), compensated=True).init(ph)
        kw = dict(iters=(2, 0), compensated=True, steps_per_call=SPC,
                  coef=coef_table(forms, dev, f32))
        return lib, lambda: fused_step_kernel(forms, state, 5e-4, **kw), SPC, BATCH
    if form == "elastic":
        from hamilton_tpu_torch.examples import elastic_pendulum

        k_res = 3.0 * 9.8
        k_grid = torch.linspace(0.35 * k_res, 2.0 * k_res, BATCH, dtype=f32, device=dev)
        system = elastic_pendulum.make_system(device=dev, dtype=f32).replace_params({
            "mass": torch.ones(BATCH, dtype=f32, device=dev),
            "gravity": torch.full((BATCH,), 9.8, dtype=f32, device=dev),
            "spring_k": k_grid, "rest_length": torch.ones(BATCH, dtype=f32, device=dev)})
        forms = system.fused_forms(system)
        q0 = torch.stack([torch.full((BATCH,), 0.01, dtype=f32, device=dev),
                          1.0 + 9.8 / k_grid + 0.15], dim=-1)
        state, table = fused_stepper(forms, iters=(2, 1)).init(tp.Phase(q0, torch.zeros_like(q0)))
        lib = kernels.build_user_family(fused_codegen.generated(forms).header)[1].paths[
            kernels.user_family_part(0, 2)]  # float32, per-member table
        kw = dict(iters=(2, 1), compensated=False, steps_per_call=1, coef=table)
        return lib, lambda: fused_step_kernel(forms, state, 5e-3, **kw), 1, BATCH
    make = {"spherical": tp.spherical_pendulum, "two_body": tp.two_body, "room": tp.room,
            "spring": tp.spring, "ellipse": tp.ellipse, "bezier5": tp.bezier,
            "bezier2": lambda **k: tp.bezier(cs.BEZIER2_POINTS, **k),
            "bezier3": lambda **k: tp.bezier(cs.BEZIER3_POINTS, **k)}[form]
    _, scale, dt = FAMILIES.get(form, (None, 0.05, 2.5e-4))  # bezier3: phase 18 (e)'s
    system = make(device=dev, dtype=f32).system
    forms = system.fused_forms(system)
    state = fused_stepper(forms, iters=(2, 0), compensated=True, steps_per_call=SPC).init(
        cs.family_phase(make(device=dev, dtype=f64), BATCH, scale, rng, dev))
    kw = dict(iters=(2, 0), compensated=True, steps_per_call=SPC)
    if form == "bezier3":
        lib = kernels.build_user_family(fused_codegen.generated(forms).header)[1].paths[
            kernels.user_family_part(0, 0)]  # float32, the constant table
    else:
        lib = kernels.build("family_step").paths[0]
        kw["coef"] = coef_table(forms, dev, f32)
    return lib, lambda: fused_step_kernel(forms, state, dt, **kw), SPC, BATCH


def _ops(block: str) -> list:
    """``[(address, opcode, operands)]`` of one function's SASS."""
    return [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)\S*([^\n]*)", block)]


def _counts(ops) -> dict:
    return {op: sum(1 for _, o, _ in ops if o == op) for op in SASS_OPS} | {
        "instructions": len(ops)}


def _step_loop(ops) -> list:
    """The instructions of the outermost loop (the widest backward branch
    and its target), or none."""
    loops = [(int(m.group(1), 16), addr) for addr, op, rest in ops if op == "BRA"
             for m in [re.search(r"0x([0-9a-f]+)", rest.split(";")[0])]
             if m and int(m.group(1), 16) < addr]
    if not loops:
        return []
    lo, hi = max(loops, key=lambda span: span[1] - span[0])
    return [o for o in ops if lo <= o[0] <= hi]


def _first_call(ops) -> list:
    """The instructions of the routine the kernel calls first (the lane
    step's factor, out of line: the peeled first step calls it before the
    solve and dH/dq), up to the next routine a call enters."""
    calls = [int(m.group(1), 16) for _, op, rest in ops if op == "CALL"
             for m in [re.search(r"0x([0-9a-f]+)", rest.split(";")[0])] if m]
    if not calls:
        return []
    first = calls[0]
    end = min((t for t in calls if t > first), default=float("inf"))
    return [o for o in ops if first <= o[0] < end]


def _sass_of(tree: Path, source: str, part) -> list:
    """``cuobjdump -sass`` of ``tree``'s own (unprobed) ``source``, built in
    a subprocess that imports the tree's package: its functions."""
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from hamilton_tpu_torch import kernels; "
             f"print(kernels.build({source!r}"
             + ("" if part is None else f", parts=({part},)") + ").paths[0])")
    lib = subprocess.run([sys.executable, "-c", build, str(tree.resolve())], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1]
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    return re.split(r"\n\s*Function : ", sass)


def _sass(tree: Path, forms) -> dict:
    """``cuobjdump -sass`` of ``tree``'s own kernels: each family form's
    float32 Kahan instantiations (shared and per-member table, one substep)
    of ``family_step.cu``, and each dense form's instantiations of
    :data:`DENSE_SASS` (the one with its counts as constants where the tree
    has it, else the one that reads them at run time), into
    ``chiprun_out/k1_sass_<form>.txt``; the counts of :data:`SASS_OPS` in
    each (for a dense form also inside its step loop)."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    counts = {}
    families = [form for form in forms if form in FAMILIES]
    blocks = _sass_of(tree, "family_step", None) if families else []
    for form in families:
        code = FAMILIES[form][0]
        text = []
        for pm in (0, 1):
            name = f"family_step_kernelIfLi{code}ELb1ELb{pm}ELb0E"
            block = next((b for b in blocks if name in b.split("\n", 1)[0]), None)
            if block is None:
                continue
            counts[f"{form} {'per-member' if pm else 'shared'}"] = _counts(_ops(block))
            text.append(f"Function : {block}")
        (out_dir / f"k1_sass_{form}.txt").write_text("\n".join(text))
    dense = [f for f in forms if f in DENSE_FORMS]
    linv = [f for f in forms if f in LINV_FORMS]
    units = {f: DENSE_FORMS[f][1:3] for f in dense} | {
        f: ("chain_variants", LINV_FORMS[f][0]) for f in linv}
    with ThreadPoolExecutor(max_workers=max(len(units), 1)) as pool:  # built at once
        sass_of = dict(zip(units, pool.map(
            lambda u: _sass_of(tree, u[0], _tree_part(tree, *u)), units.values())))
    for form in linv:
        block = next((b for b in sass_of[form]
                      if all(k in b.split("\n", 1)[0] for k in LINV_SASS)), None)
        if block is None:
            continue
        ops = _ops(block)
        counts[f"{form} step loop"] = _counts(_step_loop(ops))
        counts[f"{form} factor"] = _counts(_first_call(ops))
        (out_dir / f"k1_sass_{form}.txt").write_text(f"Function : {block}")
    for form in dense:
        blocks = sass_of[form]
        text = []
        for label, prefix, (ip, iq) in DENSE_SASS[form]:
            heads = {b.split("\n", 1)[0]: b for b in blocks}
            block = next((b for h, b in heads.items() if f"{prefix}Li{ip}ELi{iq}E" in h), None)
            block = block or next((b for h, b in heads.items() if f"{prefix}E" in h), None)
            if block is None:
                continue
            ops = _ops(block)
            counts[f"{form} {label}"] = _counts(ops)
            counts[f"{form} {label} step loop"] = _counts(_step_loop(ops))
            text.append(f"Function : {block}")
        (out_dir / f"k1_sass_{form}.txt").write_text("\n".join(text))
    return counts


def _tree_part(tree: Path, source: str, code: int) -> int:
    """The part of ``tree``'s ``source`` that holds its float32 dense case
    ``code`` (``kernels.PARTS``, read from the tree's package)."""
    get = ("import sys; sys.path.insert(0, sys.argv[1]); "
           "from hamilton_tpu_torch import kernels; "
           f"print(kernels.PARTS[{source!r}][1](0, {code}, False))")
    return int(subprocess.run([sys.executable, "-c", get, str(tree.resolve())],
                              capture_output=True, text=True, check=True).stdout.split()[-1])


def main(argv) -> int:
    tree, sass = ROOT, False
    while argv and argv[0].startswith("--"):
        if argv[0] == "--tree":
            tree, argv = Path(argv[1]), argv[2:]
        elif argv[0] == "--sass":
            sass, argv = True, argv[1:]
        else:
            print(__doc__, file=sys.stderr)
            return 2
    forms = argv or ["semiseparable"]
    unknown = [f for f in forms if f not in CHAINS and f not in FAMILIES and f not in GENERATED
               and f not in LANE_FORMS and f not in WIDE_FORMS and f not in DENSE_FORMS
               and f not in LINV_FORMS]
    if unknown:
        print(f"unknown forms {unknown}\n{__doc__}", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sass_counts = _sass(tree, forms) if sass else None
    for form, c in (sass_counts or {}).items():
        print(f"sass {tree} {form}: " + ", ".join(f"{k} {v}" for k, v in c.items()), flush=True)
    if "semiseparable" in forms and "semiseparable20" in forms:
        print("semiseparable and semiseparable20 need separate calls", file=sys.stderr)
        return 2
    where = _copy(tree, one_thread="semiseparable" in forms)
    sys.path[:0] = [str(where), str(ROOT)]
    import torch

    from hamilton_tpu_torch import kernels

    if not Path(kernels.__file__).is_relative_to(where):
        raise RuntimeError(f"imported {kernels.__file__}, not the copy in {where}")
    from hamilton_tpu_torch.utils.profiling import time_queued

    dev = torch.device("cuda")
    # the dense forms' parts, built at once
    units = {(DENSE_FORMS[f][1], kernels.PARTS[DENSE_FORMS[f][1]][1](0, DENSE_FORMS[f][2], False))
             for f in forms if f in DENSE_FORMS}
    with ThreadPoolExecutor(max_workers=max(len(units), 1)) as pool:
        list(pool.map(lambda u: kernels.build(u[0], parts=(u[1],)), units))
    runs = {form: _launch(form, dev) for form in forms}
    rows = {}
    for form, (lib_path, launch, spc, batch) in runs.items():
        lib = ctypes.CDLL(str(lib_path))
        launch()
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 8)()
        lib.hamilton_phase_cycles(out, 1)
        launch()
        torch.cuda.synchronize()
        if lib.hamilton_phase_cycles(out, 0) != 0:
            raise RuntimeError("reading the phase counters failed")
        lanes = (kernels.lane_layout("fused_step", 0, LANE_FORMS[form][0], semiseparable=False)[0]
                 if form in LANE_FORMS else
                 kernels.lane_layout("chain_variants", 0, LINV_FORMS[form][0])[0]
                 if form in LINV_FORMS else
                 kernels.lane_layout(WIDE_FORMS[form][0], 0, WIDE_FORMS[form][1])[0]
                 if form in WIDE_FORMS else 1)
        warp_steps = (batch * lanes + 31) // 32 * spc
        cycles = {name: out[k] / warp_steps for k, name in enumerate(PHASES)}
        cycles["step"] = out[5] / warp_steps
        if form in WIDE_FORMS:  # the shift to q1 and the hand-off
            cycles = {"aux": cycles["aux"], "aux shift": cycles["aux_at"],
                      "factor": cycles["factor"], "solves": cycles["solve"],
                      "dH/dq": cycles["dhdq"], "hand-off": out[6] / warp_steps,
                      "step": cycles["step"]}
        if form in DENSE_FORMS:  # the chain's names of the phases
            cycles = {"aux": cycles["aux"], "aux shift": cycles["aux_at"],
                      "factor": cycles["factor"], "solves": cycles["solve"],
                      "dH/dq": cycles["dhdq"], "step": cycles["step"]}
        if form in LINV_FORMS:  # the L^-1 lane step's phases
            generators = out[7] / warp_steps
            cycles = {"aux": cycles["aux"] + cycles["aux_at"], "generators": generators,
                      "columns": cycles["factor"] - generators, "solves": cycles["solve"],
                      "dH/dq": cycles["dhdq"], "step": cycles["step"]}
        if form in LANE_FORMS:  # the dense lane step's phases
            back = out[6] / warp_steps
            cycles = {"aux": cycles["aux"] + cycles["aux_at"], "K and factor": cycles["factor"],
                      "forward solves": cycles["solve"] - back, "back-solve chain": back,
                      "dH/dq": cycles["dhdq"], "step": cycles["step"]}
        ms, _ = time_queued(launch, 20)
        rows[form] = {"cycles_per_warp_step": cycles, "probed_ms": ms, "lanes": lanes}
        print(f"{tree} {form}: a warp's step {cycles['step']:.0f} cycles: " + ", ".join(
            f"{k} {v:.0f} ({v / cycles['step']:.3f})" for k, v in cycles.items() if k != "step")
            + f"; probed launch {ms:.4f} ms", flush=True)
    print(json.dumps({"card": card, "tree": str(tree), "rows": rows, "sass": sass_counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
