#!/usr/bin/env python3
"""The dense lanes' factor out of line at G = 2: which variants of
``csrc/dense_lanes.cuh`` read back wrong float32 states on one card, and
what their machine code differs in.

    python3 scripts/dense_outlined_probe.py [--variants NAME,...] [--cap SECONDS]
    python3 scripts/dense_outlined_probe.py --check-only [--variants NAME,...]

The shipped kernel calls the dense chain's factor inlined at each call site
(``DenseLaneForms::factor``).  Each variant is a copy of this checkout's
``csrc/`` under ``hamilton_tpu_torch/_build/dense_outlined/<name>/`` with
exact texts replaced (raising if a text moved), built as
``csrc/fused_step.cu``'s float32 dense n = 20 part with that part's flags
(``kernels._flags``; ``ptxas-O1`` adds ``-Xptxas -O1``); none is shipped:

- ``inline-g2``: the lanes a member at n = 20 in float32 set to 2;
- ``outlined-g2``: and the factor called out of line (``lane_call``, as the
  L^-1 form's routines at n = 20), the configuration that read back wrong
  states on the card when the lanes were first built;
- ``outlined-g4``: the factor out of line at the shipped 4 lanes;
- ``outlined-g2-regs255``: ``outlined-g2`` built for 255 registers a thread
  (``dense_registers``), so the factor's caller and callee need no spills;
- ``outlined-g2-fenced``: ``outlined-g2`` with ``__threadfence_block()``
  after each ``__syncwarp`` of the factor;
- ``outlined-g2-fullwarp``: ``outlined-g2`` with the factor's
  ``__syncwarp(mask)`` over the whole warp (the batches here fill whole
  warps, so every lane reaches each);
- ``outlined-g2-ptxas-O1``: ``outlined-g2`` at ptxas's -O1.

Beside them, ``factor-alone``: a kernel of its own (``FACTOR_ALONE``) that
runs only the aux and the factor at G = 2 and 4, inlined and out of line,
and writes each member's triangle out: the out-of-line factor against the
inlined one, bit for bit or not.

Every build runs at once, one nvcc each (``--cap`` seconds at most; a
variant's library already in its directory is reused), and logs its ``-Xptxas -v`` registers, stack frames and spills (the kernels'
and the out-of-line factor's).  Then each variant and the shipped part run
one step of ``k1_route_ab.py``'s ``dense20`` case ((2,1) Kahan, dt = 1e-3,
f32) on 1024 and 16384 members of ``chip_smoke.jittered_phase`` against the
plain version: bitwise or not, the members that differ (their count, the
first, their slots in a warp) and the state rows that differ.  Without
``--check-only``, ``cuobjdump -sass`` of the kernel (Kahan, shared table, not
composed) and of the out-of-line factor of ``inline-g2`` and
``outlined-g2`` goes to ``chiprun_out/dense_outlined_sass/``, with each
function's instructions counted by opcode, and nvcc's version is logged.
The log goes to ``chiprun_out/dense_outlined_probe.log`` (with
``--check-only``, ``dense_outlined_probe-check.log``); the last line is
JSON ``{"card", "nvcc", "builds", "checks", "factor_alone", "sass"}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import k1_route_ab as ab  # noqa: E402

SCRATCH = REPO / "hamilton_tpu_torch" / "_build" / "dense_outlined"
OUT = REPO / "chiprun_out"
_LOG = OUT / "dense_outlined_probe.log"
BATCHES = (1024, 16384)
N, ITERS, DT = 20, (2, 1), 1e-3

FACTOR_SYNC = "    __syncwarp(mask);  // column j before the lanes read it\n"
RUN_SYNCS = ("    __syncwarp(Sh::mask());  // every lane is done with the last factor\n",
             "      __syncwarp(Sh::mask());\n      if (ok) return;\n",
             "    dense_factor_pass<false, Sh>(cf);\n    __syncwarp(Sh::mask());\n")

#: variant → (lanes, out of line, {file: [(text, replacement)]}, extra nvcc flags)
VARIANTS = {
    "inline-g2": (2, False, {}, ()),
    "outlined-g2": (2, True, {}, ()),
    "outlined-g4": (4, True, {}, ()),
    "outlined-g2-regs255": (2, True, {"dense_lanes.cuh": [(
        "return item == 4 ? 128 : 255;", "return item == 4 ? 255 : 255;")]}, ()),
    "outlined-g2-fenced": (2, True, {"dense_lanes.cuh": [
        (FACTOR_SYNC, FACTOR_SYNC + "    __threadfence_block();\n")] + [
        (t, t.replace("__syncwarp(Sh::mask());", "__syncwarp(Sh::mask()); __threadfence_block();"))
        for t in RUN_SYNCS]}, ()),
    "outlined-g2-fullwarp": (2, True, {"dense_lanes.cuh": [
        (FACTOR_SYNC, FACTOR_SYNC.replace("__syncwarp(mask)", "__syncwarp(0xffffffffu)"))] + [
        (t, t.replace("__syncwarp(Sh::mask())", "__syncwarp(0xffffffffu)")) for t in RUN_SYNCS]},
        ()),
    "outlined-g2-ptxas-O1": (2, True, {}, ("-Xptxas", "-O1")),
}

#: the kernel (float, n = 20, G, Kahan, shared table, not composed, dense)
#: and the out-of-line factor, in cuobjdump's mangled names
_KERNEL_SASS = re.compile(r"lane_kernelIfLi20ELi(\d)ELb1ELb0ELb0ELi1E")
_FACTOR_SASS = re.compile(r"lane_outlinedI.*DenseFactorLanesI.*DenseShapeIfLi20ELi(\d)E")
OPS = ("WARPSYNC", "SHFL", "BAR", "LDS", "STS", "LDL", "STL", "CALL", "RET", "BSSY", "BSYNC",
       "MEMBAR", "NANOSLEEP", "BRA", "MUFU")


#: The factor alone: each member's aux (sin and cos of its q) into its slots,
#: then the dense factor of K at n = 20 on G lanes, inlined or out of line,
#: then the member's triangle (the factor, 1/d on its diagonal) written out
#: batch-minor.  Built from a copy of this checkout's headers, with the
#: flags of fused_step.cu's dense n = 20 part.
FACTOR_ALONE = r"""
#include "dense_lanes.cuh"

namespace {

template <int G, bool OUTLINED>
__global__ void __launch_bounds__(DenseShape<float, 20, G>::kBlock)
    factor_alone(const float* __restrict__ coef, const float* __restrict__ q,
                 float* __restrict__ out, long long batch) {
  using Sh = DenseShape<float, 20, G>;
  using Forms = DenseLaneForms<Sh, SharedSlots<Sh>>;
  float* cf = Sh::table();
  for (int k = threadIdx.x; k < Sh::kTable; k += blockDim.x) cf[k] = coef[k];
  __syncthreads();
  const long long b = static_cast<long long>(blockIdx.x) * Sh::kMembers + threadIdx.x / G;
  if (b >= batch) return;
  Forms forms(SharedSlots<Sh>{});
  float x[Sh::J];
#pragma unroll
  for (int m = 0; m < Sh::J; ++m) x[m] = q[(forms.mine(m) ? forms.link(m) : 0) * batch + b];
  forms.aux(x);
  if constexpr (OUTLINED)
    lane_call<DenseFactorLanes<Sh, SharedSlots<Sh>>, 20>(SharedSlots<Sh>{});
  else
    DenseFactorLanes<Sh, SharedSlots<Sh>>::run(SharedSlots<Sh>{});
  __syncwarp(Sh::mask());
  const float* mem = Sh::member();
  for (int e = Sh::lane(); e < Sh::kS; e += G) out[e * batch + b] = mem[e * Sh::S];
}

template <int G, bool OUTLINED>
int launch(const float* coef, const float* q, float* out, long long batch) {
  using Sh = DenseShape<float, 20, G>;
  cudaError_t e = cudaFuncSetAttribute(factor_alone<G, OUTLINED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(Sh::kBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (batch + Sh::kMembers - 1) / Sh::kMembers;
  factor_alone<G, OUTLINED><<<static_cast<unsigned>(blocks), Sh::kBlock, Sh::kBytes>>>(
      coef, q, out, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hamilton_factor_alone(int lanes, int outlined, const float* coef, const float* q,
                                     float* out, long long batch) {
  if (lanes == 2) return outlined ? launch<2, true>(coef, q, out, batch)
                                  : launch<2, false>(coef, q, out, batch);
  if (lanes == 4) return outlined ? launch<4, true>(coef, q, out, batch)
                                  : launch<4, false>(coef, q, out, batch);
  return -1;
}
"""


def log(msg: str) -> None:
    print(msg, flush=True)
    with open(_LOG, "a") as f:
        f.write(msg + "\n")


def make_copy(name: str) -> Path:
    lanes, outlined, edits, _ = VARIANTS[name]
    where = ab._copy_csrc(SCRATCH / name, {"kDenseLanes20F": lanes}, outlined)
    for fname, pairs in edits.items():
        path = where / fname
        text = path.read_text()
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {fname} holds {text.count(old)} copies of "
                                   f"{old!r}, expected one")
            text = text.replace(old, new)
        path.write_text(text)
    return where


_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _sass_parts(text: str):
    """The kernel of :data:`_KERNEL_SASS` in ``cuobjdump -sass`` output and
    the routine it calls out of line (its code follows the kernel's in the
    same function block, from a ``CALL.REL.NOINC`` target to the first
    unpredicated ``RET``): ``{"kernel": lines, "factor": lines}``."""
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        if not _KERNEL_SASS.search(block.split("\n", 1)[0]):
            continue
        lines = [line for line in block.splitlines() if _INSTRUCTION.search(line)]
        targets = {int(t, 16) for t in re.findall(r"CALL\.REL\.NOINC (0x[0-9a-f]+)", block)}
        start = min(targets) if targets else None
        kernel, factor, inside = [], [], False
        for line in lines:
            m = _INSTRUCTION.search(line)
            addr = int(m.group(1), 16)
            if start is not None and addr == start:
                inside = True
            (factor if inside else kernel).append(line)
            if inside and m.group(3).startswith("RET") and not m.group(2):
                inside, start = False, None
        return {"kernel": kernel, "factor": factor}
    return {}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--cap", type=float, default=600.0)
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args(argv)
    names = [v for v in args.variants.split(",") if v]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"dense_outlined_probe: no variant {sorted(unknown)}")
    OUT.mkdir(exist_ok=True)
    global _LOG
    if args.check_only:
        _LOG = OUT / "dense_outlined_probe-check.log"
    _LOG.write_text("")

    import torch

    import chip_smoke as cs
    import hamilton_tpu_torch as tp
    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.ops import fused_step as fs

    if not torch.cuda.is_available():
        raise SystemExit("dense_outlined_probe: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    nvcc = kernels._nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[-1]
    log(f"card: {card}; {version}")
    part = kernels.PARTS["fused_step"][1](0, N, False)
    flags = kernels._flags("fused_step", part)
    units = {"shipped": None}
    for name in names:
        where = make_copy(name)
        units[name] = ([nvcc, *flags, *VARIANTS[name][3], str(where / "fused_step.cu")],
                       where / f"lib{name}.so", where / f"lib{name}.log")
    alone = ab._copy_csrc(SCRATCH / "factor-alone")
    (alone / "factor_alone.cu").write_text(FACTOR_ALONE)
    alone_flags = [f for f in flags if not f.startswith("-DHAMILTON_PART")]
    units["factor-alone"] = ([nvcc, *alone_flags, str(alone / "factor_alone.cu")],
                             alone / "libfactor_alone.so", alone / "libfactor_alone.log")
    builds = {}
    t0 = time.perf_counter()
    def build(cmd, lib, report, cap):
        """A variant's earlier build in this directory, or nvcc now."""
        if lib.exists() and report.exists():
            return 0.0, report.read_text()
        return ab._nvcc(cmd, lib, report, cap)

    with ThreadPoolExecutor(max_workers=len(units)) as pool:
        futures = {pool.submit(build, *units[name], args.cap): name
                   for name in names + ["factor-alone"]}
        futures[pool.submit(kernels.build, "fused_step", (part,))] = "shipped"
        for fut in as_completed(futures):
            name = futures[fut]
            if name == "shipped":
                b = fut.result()
                lib, seconds, text = b.paths[0], b.seconds, b.log
            else:
                seconds, text = fut.result()
                lib = units[name][1]
            frames = {**cs.ptxas_frames(text, cs._KERNEL_RE, cs._k1_label),
                      **cs.ptxas_frames(text, ab._OUTLINED_RE, ab._outlined_label)}
            builds[name] = {"lib": str(lib) if seconds is not None else None,
                            "seconds": seconds,
                            "frames": {k: v for k, v in frames.items()
                                       if "n=20" in k and ("float" in k or "f32" in k)}}
            log(f"build {name}: " + ("stopped at the cap" if seconds is None else
                                     f"nvcc {seconds:.1f} s ({time.perf_counter() - t0:.1f} s "
                                     f"into the builds)"))
            for kname, (stack, st, ld) in builds[name]["frames"].items():
                log(f"  ptxas {kname:<55} stack frame {stack} B, spill stores {st} B, "
                    f"spill loads {ld} B")

    # ---- one step against the plain version ----------------------------------
    ex = tp.chain(n_links=N, fused_solver="dense", device=dev, dtype=torch.float32)
    forms = ex.system.fused_forms(ex.system)
    coef = fs.coef_table(forms, dev, torch.float32)
    stepper = fs.fused_stepper(forms, iters=ITERS, compensated=True)
    weights = (ctypes.c_double * 1)(1.0)
    rows = ("q", "p", "cq", "cp", "a_est", "vdot_est")
    checks = {}
    for batch in BATCHES:
        state = stepper.init(cs.jittered_phase(ex, batch, torch.float32, dev, 3))
        want = fs.fused_step_reference(forms, state, DT, iters=ITERS, compensated=True)
        for name, b in builds.items():
            if b["lib"] is None or name == "factor-alone":
                continue
            lib = ctypes.CDLL(b["lib"])
            entry = lib.hamilton_fused_step
            entry.argtypes = kernels._SIGNATURES["fused_step"]["hamilton_fused_step"]
            entry.restype = ctypes.c_int
            got = torch.empty_like(state)
            code = entry(0, N, 2, coef.data_ptr(), state.data_ptr(), got.data_ptr(), batch, DT,
                         ITERS[0], ITERS[1], 1, 1, weights,
                         torch.cuda.current_stream(dev).cuda_stream)
            torch.cuda.synchronize()
            if code != 0:
                raise RuntimeError(f"{name}: the kernel returned {code}")
            differ = ((got != want) & ~(got.isnan() & want.isnan()))
            members = differ.any(0).any(0).nonzero()[:, 0]
            lanes = VARIANTS[name][0] if name in VARIANTS else 4
            slots = Counter(int(m) % (32 // lanes) for m in members.tolist())
            rec = {"bitwise": bool(torch.equal(got, want)), "members_differ": len(members),
                   "first": members[:8].tolist(),
                   "slots_in_warp": dict(sorted(slots.items())),
                   "rows_differ": [r for r, d in zip(rows, differ.any(-1).any(-1).tolist()) if d],
                   "max_abs": float((got.double() - want.double()).abs()[:2].max()),
                   "finite": bool(torch.isfinite(got).all())}
            checks[f"{name} B={batch}"] = rec
            log(f"check {name}, {batch} members, one step: bitwise {rec['bitwise']}, "
                f"{rec['members_differ']} members differ (the first {rec['first']}; by slot "
                f"in a warp {rec['slots_in_warp']}), rows {rec['rows_differ']}, max |q, p| "
                f"diff {rec['max_abs']:.3e}, finite {rec['finite']}")

    # ---- the factor alone, inlined and out of line ------------------------------
    alone = {}
    if builds["factor-alone"]["lib"] is not None:
        lib = ctypes.CDLL(builds["factor-alone"]["lib"])
        entry = lib.hamilton_factor_alone
        entry.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_longlong]
        entry.restype = ctypes.c_int
        def factor(lanes, outlined, q, batch):
            out = torch.full((N * (N + 1) // 2, batch), float("nan"), device=dev)
            code = entry(lanes, outlined, coef.data_ptr(), q.data_ptr(), out.data_ptr(), batch)
            torch.cuda.synchronize()
            if code != 0:
                raise RuntimeError(f"factor alone G={lanes}: the kernel returned {code}")
            return out

        first = {}
        for batch in BATCHES:
            q = cs.jittered_phase(ex, batch, torch.float32, dev, 3).q.T.contiguous()
            got = {(lanes, outlined): factor(lanes, outlined, q, batch)
                   for lanes in (2, 4) for outlined in (0, 1)}
            # the same launch again: a schedule-dependent result differs
            again = factor(2, 1, q, batch)
            same = (again == got[(2, 1)]) | (again.isnan() & got[(2, 1)].isnan())
            first[batch] = got[(2, 1)][:, :min(BATCHES)]
            alone[f"G=2 B={batch} repeat"] = {"members_differ": int((~same).any(0).sum())}
            log(f"factor alone G=2 out of line, {batch} members, the same launch twice: "
                f"{int((~same).any(0).sum())} members differ between the two")
            for lanes in (2, 4):
                a, b = got[(lanes, 0)], got[(lanes, 1)]
                differ = (a != b) & ~(a.isnan() & b.isnan())
                rec = {"bitwise": bool(torch.equal(a, b)),
                       "members_differ": int(differ.any(0).sum()),
                       "entries_differ": int(differ.any(1).sum()),
                       "first_entries": differ.any(1).nonzero()[:8, 0].tolist(),
                       "finite_inlined": bool(torch.isfinite(a).all()),
                       "finite_outlined": bool(torch.isfinite(b).all()),
                       "inlined_equals_g4": bool(torch.equal(a, got[(4, 0)]))}
                alone[f"G={lanes} B={batch}"] = rec
                log(f"factor alone G={lanes}, {batch} members: out of line bitwise the "
                    f"inlined {rec['bitwise']}, {rec['members_differ']} members and "
                    f"{rec['entries_differ']} of {N * (N + 1) // 2} entries differ (the first "
                    f"{rec['first_entries']}), finite inlined {rec['finite_inlined']} and out "
                    f"of line {rec['finite_outlined']}; inlined equals G = 4's "
                    f"{rec['inlined_equals_g4']}")

        # one member a launch (its warp's other lanes exit), then one warp's 16
        for batch in (1, 16):
            q = cs.jittered_phase(ex, batch, torch.float32, dev, 3).q.T.contiguous()
            a, b = factor(2, 0, q, batch), factor(2, 1, q, batch)
            differ = ((a != b) & ~(a.isnan() & b.isnan())).any(0)
            alone[f"G=2 B={batch}"] = {"members_differ": int(differ.sum())}
            log(f"factor alone G=2, {batch} member(s): {int(differ.sum())} differ between "
                f"inlined and out of line")
        a, b = first[BATCHES[0]], first[BATCHES[-1]]
        same = (a == b) | (a.isnan() & b.isnan())
        alone["first members across batches"] = {"members_differ": int((~same).any(0).sum())}
        log(f"factor alone G=2 out of line: the first {min(BATCHES)} members (the same "
            f"inputs) at {BATCHES[0]} and at {BATCHES[-1]} members: "
            f"{int((~same).any(0).sum())} differ")

    # ---- the machine code --------------------------------------------------------
    sass = {}
    if not args.check_only:
        cuobjdump = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
        where = OUT / "dense_outlined_sass"
        where.mkdir(exist_ok=True)
        for name in ("inline-g2", "outlined-g2"):
            if builds.get(name, {}).get("lib") is None:
                continue
            text = subprocess.run([cuobjdump, "-sass", builds[name]["lib"]], capture_output=True,
                                  text=True, check=True).stdout
            for kind, lines in _sass_parts(text).items():
                if not lines:
                    continue
                (where / f"{name}-{kind}.sass").write_text("\n".join(lines) + "\n")
                counts = Counter(_INSTRUCTION.search(line).group(3).split(".")[0]
                                 for line in lines)
                sass[f"{name} {kind}"] = {"instructions": len(lines),
                                          **{op: counts.get(op, 0) for op in OPS}}
                log(f"sass {name} {kind}: {len(lines)} instructions; " + ", ".join(
                    f"{op} {counts.get(op, 0)}" for op in OPS))
    log(json.dumps({"card": card, "nvcc": version, "builds": builds, "checks": checks,
                    "factor_alone": alone, "sass": sass}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
