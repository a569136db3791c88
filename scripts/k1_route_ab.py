#!/usr/bin/env python3
"""K1's chain cases at 20 and 40 links: each candidate kernel in turns on one
card, to route each case to the fastest.

    python3 scripts/k1_route_ab.py [--pairs 10] [--cap 900] [--hand-tree DIR]
                                   [--lanes N:G,G,...] [--wide-lanes G[:U],...]
                                   [--routes KIND,...] [--dtype float32|float64]
                                   [--outlined] [CASE ...]

CASE is ``dense20`` (the reference's default chain, ``leapfrog_fused``
(2,1), dt = 1e-3), ``dense40`` (its stress chain, dense, (2,0), dt = 5e-4),
``semiseparable40`` (the stress chain's other form), ``semiseparable20``
(the headline: the default chain's semiseparable form, (2,0), dt = 5e-4,
the shared table), ``sweep20`` (the headline on per-member tables: masses
and gravity drawn a member) or ``suzuki20`` (the headline's kernel running
``suzuki4_fused``, dt = 1e-3); ``dense20 dense40`` by default.  Each runs
on 16384 members, float32 (or ``--dtype``) with Kahan compensation, 50
steps a launch, on these routes (every build without FMA contraction but
the n = 20 semiseparable cases', built as ``csrc/fused_step.cu``'s part
ships them, with it):

- ``lanes G=g`` (the dense cases): ``csrc/fused_step.cu``'s dense chain on
  g lanes a member (``csrc/dense_lanes.cuh``): the checkout's own part at
  the lanes it ships, and for each other g that ``--lanes N:...`` lists a
  copy of the sources under ``_build/k1_route_ab/`` with the constant
  ``kDenseLanes<N>F`` (``D`` in float64) set to it; with ``--outlined``,
  ``lanes G=g outlined``, the shipped lanes with the factor called out of
  line (``lane_call``) as the L^-1 form's routines are;
- ``generated`` (``dense20``, ``semiseparable40``): the dtype's part on the
  constant table of ``csrc/user_family_step.cu`` around the header that
  ``ops/fused_codegen.py`` makes from the chain's forms;
- ``wide G=g`` (``semiseparable40``): ``csrc/semisep_wide.cu``, the member's
  working set in shared memory and registers on g lanes a member (the link
  split, ``csrc/semisep_wide.cuh``): the checkout's own part at the lanes
  it ships, and for each other g that ``--wide-lanes`` lists a copy of the
  sources under ``_build/k1_route_ab/`` with ``kWideLanesF`` (``D`` in
  float64) set to it; ``g:u`` also sets ``kScanUnrollF`` (``D``), the links
  a scan's loop unrolls, to u (``wide G=g U=u``); for the n = 20
  semiseparable cases ``csrc/fused_step.cu``'s part (its link split,
  ``kWide20LanesF``, ``D``), the vectors in registers but with ``g:u`` for
  u > 0 (``kWide20Unroll``: in shared memory, unrolled u links at a
  time);
- ``hand``: the one-thread template ``step_member``: for ``dense40`` the
  dtype's dense n = 40 part of ``DIR/hamilton_tpu_torch/csrc/fused_step.cu``
  (``--hand-tree``, a tree whose source holds it, its loops rolled: a
  parent unpacked with ``git archive`` into ``_archive/parent``); for
  ``semiseparable40`` a copy of this source with the case added to its
  dispatch; for the n = 20 semiseparable cases a copy of this source with
  ``kWide20LanesF`` (``D``) set to 0.

``--variant NAME=V[,NAME=V...]`` (repeatable; the n = 20 semiseparable
cases) adds a route ``wide NAME=V,...``: a copy of the sources with those
constants of ``csrc/fused_step.cu`` and ``csrc/semisep_wide.cuh`` set
(e.g. ``kWide20LanesF=4,kWide20Unroll=5``).

``--routes`` keeps the routes of those kinds (``lanes``, ``generated``,
``hand``, ``wide``; all by default): ``--routes lanes`` sweeps the lanes a
member.

Every build runs at once, one nvcc each, each stopped after ``--cap``
seconds; each logs its seconds, ``-Xptxas -v`` registers, stack frame and
spills as it ends, and a lane route the layout its library reports (lanes,
threads and shared bytes a block, blocks an SM).  Then each kernel that
built is held against the plain version over one step (the n = 20
semiseparable cases: 50, as ``chip_smoke.TOL`` was read) on 1000 members and
on the timed 16384 (``chip_smoke.TOL``, bitwise logged; a route that fails
is not timed, and the script exits 1), and ``--pairs`` rounds time
the routes in turn (the order rotating a round), each reading the device ms
of one launch from CUDA events around launches queued behind a held stream
(``utils.profiling.time_queued``).  Prints the card's name and power limit,
a line per build and reading, and a last line of JSON: ``{"card": ...,
"builds": {label: {"seconds": s or null, "ptxas": [...], "frames": {...},
"layout": [...]}}, "cases": {case: {"max_err": {...}, "bitwise": {...},
"ms": {route: [...]}, "median_ms": {...}}}}``.  The log also goes,
line by line, to ``k1_route_ab.log`` in the repository's output
directory (``_LOG``).
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

#: case → (n, fused_solver, iters, dt, per-member tables, composition)
CASES = {
    "dense20": (20, "dense", (2, 1), 1e-3, False, (1.0,)),
    "dense40": (40, "dense", (2, 0), 5e-4, False, (1.0,)),
    "semiseparable40": (40, "semiseparable", (2, 0), 5e-4, False, (1.0,)),
    "semiseparable20": (20, "semiseparable", (2, 0), 5e-4, False, (1.0,)),
    "sweep20": (20, "semiseparable", (2, 0), 5e-4, True, (1.0,)),
    "suzuki20": (20, "semiseparable", (2, 0), 1e-3, False,
                 # fused_step.SUZUKI4_COMPOSITION, the weights suzuki4_fused runs
                 None),
}
#: the n = 20 semiseparable cases share one build a route, under this case's
#: labels
N20_CASES = ("semiseparable20", "sweep20", "suzuki20")


def _build_case(case: str) -> str:
    return "semiseparable20" if case in N20_CASES else case
BATCH = 16384
SPC = 50
CHECK_BATCH = 1000
SCRATCH = REPO / "hamilton_tpu_torch" / "_build" / "k1_route_ab"

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


#: ``dense_lanes.cuh``'s factor call, inlined as shipped, and out of line
OUTLINED = ("DenseFactorLanes<Sh, C>::run(cf);", "lane_call<DenseFactorLanes<Sh, C>, N>(cf);")
#: the out-of-line dense factor (``chain_lanes.cuh``'s ``lane_outlined``) at
#: ``DenseShape<T, n, lanes>``, in nvcc's report
_OUTLINED_RE = re.compile(
    r"lane_outlinedI.*?DenseFactorLanesI.*?DenseShapeI([fd])Li(\d+)ELi(\d+)E")


def _outlined_label(m):
    t, n, lanes = m.groups()
    return f"{'float' if t == 'f' else 'double'} n={n} G={lanes} factor (out of line)"


def _copy_csrc(where: Path, consts=None, outlined=False, target="dense_lanes.cuh") -> Path:
    """A copy of this checkout's ``csrc/`` in ``where``, each ``name = value``
    of ``consts`` set in ``target`` (a file name, or a tuple of them: each
    name set once in one of them), and the dense factor called out of line
    where ``outlined``; the copied directory."""
    csrc = REPO / "hamilton_tpu_torch" / "csrc"
    where.mkdir(parents=True, exist_ok=True)
    targets = (target,) if isinstance(target, str) else target
    set_count = dict.fromkeys(consts or {}, 0)
    for path in list(csrc.glob("*.cuh")) + [csrc / "fused_step.cu", csrc / "semisep_wide.cu"]:
        text = path.read_text()
        if path.name in targets:
            for name, value in (consts or {}).items():
                text, count = re.subn(rf"\b{name} = \d+", f"{name} = {value}", text)
                set_count[name] += count
        if outlined and path.name == "dense_lanes.cuh":
            if text.count(OUTLINED[0]) != 1:
                raise RuntimeError(f"{path}: the factor's call has changed")
            text = text.replace(*OUTLINED)
        (where / path.name).write_text(text)
    unset = {name: count for name, count in set_count.items() if count != 1}
    if unset:
        raise RuntimeError(f"{targets}: constants set other than once: {unset}")
    return where


def _add_variant(src: Path, n: int, semi: bool, variants) -> int:
    """Add ``(n, semi)`` to the dispatch of ``src`` (a copied
    ``fused_step.cu``) as the variant after its own; that variant."""
    v = len(variants)
    cond = "semiseparable" if semi else "!semiseparable"
    line = (f"  if ({cond} && n == {n}) return f(Variant<{v}, {n}, "
            f"{'true' if semi else 'false'}>{{}});\n")
    anchor = "  return -1;\n}\n\ntemplate <typename T>\nint launch_dispatch"
    text = src.read_text()
    if anchor not in text:
        raise RuntimeError("fused_step.cu's dispatch has changed: update _add_variant")
    src.write_text(text.replace(anchor, line + anchor))
    return v


def _tree_variants(tree: Path) -> dict:
    """``FUSED_STEP_VARIANTS`` of the tree's ``kernels/__init__.py``."""
    text = (tree / "hamilton_tpu_torch" / "kernels" / "__init__.py").read_text()
    m = re.search(r"^FUSED_STEP_VARIANTS = (\{[^}]*\})", text, flags=re.M)
    if m is None:
        raise RuntimeError(f"{tree}: no FUSED_STEP_VARIANTS")
    return ast.literal_eval(m.group(1))


def _parse_lanes(specs):
    """``["20:2,4,8", ...]`` → ``{20: [2, 4, 8], ...}``."""
    out = {}
    for spec in specs:
        n, gs = spec.split(":")
        out[int(n)] = [int(g) for g in gs.split(",") if g]
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--cap", type=float, default=900.0)
    ap.add_argument("--hand-tree", type=Path, default=None)
    ap.add_argument("--lanes", action="append", default=[])
    ap.add_argument("--wide-lanes", default="")
    ap.add_argument("--routes", default="lanes,generated,hand,wide")
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--outlined", action="store_true")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("cases", nargs="*", default=["dense20", "dense40"])
    args = ap.parse_args(argv)
    _LOG.parent.mkdir(exist_ok=True)
    _LOG.write_text("")
    extra_lanes = _parse_lanes(args.lanes)

    import numpy as np
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
    dtype = getattr(torch, args.dtype)
    dcode, letter = (0, "F") if dtype == torch.float32 else (1, "D")
    nvcc = kernels._nvcc()
    shipped = {}  # n → the lanes a member this checkout ships in the dtype
    for n in (20, 40):
        text = (REPO / "hamilton_tpu_torch" / "csrc" / "dense_lanes.cuh").read_text()
        shipped[n] = int(re.search(rf"\bkDenseLanes{n}{letter} = (\d+)", text).group(1))
    wide_text = (REPO / "hamilton_tpu_torch" / "csrc" / "semisep_wide.cu").read_text()
    wide_shipped = int(re.search(rf"\bkWideLanes{letter} = (\d+)", wide_text).group(1))
    k1_text = (REPO / "hamilton_tpu_torch" / "csrc" / "fused_step.cu").read_text()
    wide20_shipped = int(re.search(rf"\bkWide20Lanes{letter} = (\d+)", k1_text).group(1))

    forms = {}
    for case in args.cases:
        n, solver = CASES[case][:2]
        system = tp.chain(n_links=n, fused_solver=solver, device=dev, dtype=dtype).system
        forms[case] = system.fused_forms(system)

    # ---- every build at once, each stopped at the cap --------------------------
    # label → (nvcc command, library, report, ptxas pattern and label, entry kind)
    units = {}
    for case in dict.fromkeys(_build_case(c) for c in args.cases):
        n, solver = CASES[case][:2]
        semi = solver == "semiseparable"
        k1 = (cs._KERNEL_RE, cs._k1_label)
        if case == "semiseparable20":
            part = kernels.PARTS["fused_step"][1](dcode, n, True)
            specs = {(wide20_shipped, None)} | {
                (int(x.split(":")[0]), int(x.split(":")[1]) if ":" in x else None)
                for x in args.wide_lanes.split(",") if x}
            specs = {s for s in specs if s[0] > 0}
            for g, unroll in sorted(specs, key=lambda s: (s[0], s[1] or 0)):
                label = f"{case} wide G={g}" + (f" U={unroll}" if unroll else "")
                if (g, unroll) == (wide20_shipped, None):
                    src, lib, report = kernels._paths("fused_step", part)
                else:
                    tag = f"wide{n}g{g}u{unroll or 0}{letter}"
                    where = _copy_csrc(SCRATCH / tag, {f"kWide20Lanes{letter}": g,
                                                       "kWide20Unroll": unroll or 0},
                                       target="fused_step.cu")
                    src = where / "fused_step.cu"
                    lib, report = where / f"lib{tag}.so", where / f"lib{tag}.log"
                units[label] = ([nvcc, *kernels._flags("fused_step", part), str(src)], lib,
                                report, k1, "fused_step")
            for k, spec in enumerate(args.variant):
                consts = dict(kv.split("=") for kv in spec.split(","))
                tag = f"wide{n}v{k}{letter}"
                where = _copy_csrc(SCRATCH / tag, consts,
                                   target=("fused_step.cu", "semisep_wide.cuh"))
                lib = where / f"lib{tag}.so"
                units[f"{case} wide {spec}"] = (
                    [nvcc, *kernels._flags("fused_step", part), str(where / "fused_step.cu")],
                    lib, lib.with_suffix(".log"), k1, "fused_step")
            where = _copy_csrc(SCRATCH / f"hand{n}s{letter}", {f"kWide20Lanes{letter}": 0},
                               target="fused_step.cu")
            lib = where / f"lib{case}-hand{letter}.so"
            units[f"{case} hand"] = ([nvcc, *kernels._flags("fused_step", part),
                                      str(where / "fused_step.cu")],
                                     lib, lib.with_suffix(".log"), k1, "fused_step")
            continue
        if not semi:
            part = kernels.PARTS["fused_step"][1](dcode, n, False)
            lanes = [(g, False) for g in sorted({shipped[n], *extra_lanes.get(n, [])})]
            for g, outlined in lanes + ([(shipped[n], True)] if args.outlined else []):
                label = f"{case} lanes G={g}" + (" outlined" if outlined else "")
                if g == shipped[n] and not outlined:
                    src, lib, report = kernels._paths("fused_step", part)
                else:
                    tag = f"{n}g{g}{'o' if outlined else ''}{letter}"
                    where = _copy_csrc(SCRATCH / f"lanes{tag}", {f"kDenseLanes{n}{letter}": g},
                                       outlined)
                    src = where / "fused_step.cu"
                    lib, report = where / f"lib{tag}.so", where / f"lib{tag}.log"
                units[label] = ([nvcc, *kernels._flags("fused_step", part), str(src)], lib,
                                report, k1, "fused_step")
        if case == "dense40" and args.hand_tree is not None:
            variants = _tree_variants(args.hand_tree)
            part = 2 * variants[(n, False)] + dcode
            src = args.hand_tree / "hamilton_tpu_torch" / "csrc" / "fused_step.cu"
            lib = SCRATCH / f"lib{case}-hand{letter}.so"
            units[f"{case} hand"] = ([nvcc, *kernels.NVCC_FLAGS, "-fmad=false",
                                      f"-DHAMILTON_PART={part}", str(src)], lib,
                                     lib.with_suffix(".log"), k1, "fused_step")
        if semi:
            specs = {(wide_shipped, None)} | {
                (int(x.split(":")[0]), int(x.split(":")[1]) if ":" in x else None)
                for x in args.wide_lanes.split(",") if x}
            for g, unroll in sorted(specs, key=lambda s: (s[0], s[1] or 0)):
                label = f"{case} wide G={g}" + (f" U={unroll}" if unroll else "")
                if (g, unroll) == (wide_shipped, None):
                    src, lib, report = kernels._paths("semisep_wide", dcode)
                else:
                    tag = f"wide{n}g{g}u{unroll or 0}{letter}"
                    consts = {f"kWideLanes{letter}": g}
                    if unroll:
                        consts[f"kScanUnroll{letter}"] = unroll
                    where = _copy_csrc(SCRATCH / tag, consts, target="semisep_wide.cu")
                    src = where / "semisep_wide.cu"
                    lib, report = where / f"lib{tag}.so", where / f"lib{tag}.log"
                units[label] = ([nvcc, *kernels._flags("semisep_wide", dcode), str(src)], lib,
                                report, (cs._WIDE_RE, cs._wide_label), "semisep_wide")
            where = _copy_csrc(SCRATCH / f"hand{n}s")
            v = _add_variant(where / "fused_step.cu", n, True, kernels.FUSED_STEP_VARIANTS)
            lib = where / f"lib{case}-hand{letter}.so"
            units[f"{case} hand"] = ([nvcc, *kernels.NVCC_FLAGS, "-fmad=false",
                                      f"-DHAMILTON_PART={2 * v + dcode}",
                                      str(where / "fused_step.cu")],
                                     lib, lib.with_suffix(".log"), k1, "fused_step")
        if case in ("dense20", "semiseparable40"):
            header = fused_codegen.generated(forms[case]).header
            key, where, flags = kernels._user_family_paths(header)
            where.mkdir(parents=True, exist_ok=True)
            (where / "user_family.h").write_text(header)
            part = kernels.user_family_part(dcode, 0)  # the constant table
            units[f"{case} generated"] = (
                [nvcc, *flags, "-I", str(where), f"-DHAMILTON_PART={part}",
                 str(kernels.USER_FAMILY_TEMPLATE)],
                where / f"libuser_family-p{part}.so", where / f"build-p{part}.log",
                (cs._USER_RE, cs._user_label), "user_family")
    kinds = set(args.routes.split(","))
    units = {label: unit for label, unit in units.items()
             if label.split()[1] in kinds}
    if not units:
        raise SystemExit("k1_route_ab: no route to build")
    builds, libs = {}, {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(units)) as pool:
        futures = {pool.submit(_nvcc, cmd, lib, report, args.cap): label
                   for label, (cmd, lib, report, _, _) in units.items()}
        for fut in as_completed(futures):
            label = futures[fut]
            seconds, text = fut.result()
            pattern, namer = units[label][3]
            rows = cs.ptxas_report(text, pattern, namer) if seconds is not None else []
            frames = {}
            if seconds is not None:
                frames = {**cs.ptxas_frames(text, pattern, namer),
                          **cs.ptxas_frames(text, _OUTLINED_RE, _outlined_label)}
            builds[label] = {"seconds": seconds, "ptxas": rows, "frames": frames}
            log(f"build {label}: " + (f"nvcc {seconds:.1f} s" if seconds is not None
                                      else f"stopped at the {args.cap:.0f} s cap")
                + f" ({time.perf_counter() - t0:.1f} s into the builds)")
            for kname, nreg, st, ld in rows:
                log(f"  ptxas {kname:<45} {nreg:3d} registers, stack frame "
                    f"{frames.get(kname, (0,))[0]} B, spill stores {st} B, spill loads {ld} B")
            for fname, (stack, st, ld) in frames.items():
                if "out of line" in fname:
                    log(f"  ptxas {fname:<45} stack frame {stack} B, spill stores {st} B, "
                        f"spill loads {ld} B")
    for label, (_, lib, _, _, kind) in units.items():
        if builds[label]["seconds"] is None:
            continue
        cdll = ctypes.CDLL(str(lib))
        entry = getattr(cdll, {"fused_step": "hamilton_fused_step",
                               "semisep_wide": "hamilton_semisep_wide_step",
                               "user_family": "hamilton_user_family_step"}[kind])
        entry.argtypes = kernels._SIGNATURES["fused_step"]["hamilton_fused_step"]
        entry.restype = ctypes.c_int
        libs[label] = (entry, kind)
        if kind in ("fused_step", "semisep_wide"):
            query = cdll.hamilton_lane_layout
            query.argtypes = kernels._SIGNATURES["fused_step"]["hamilton_lane_layout"]
            n, solver = CASES[label.split()[0]][:2]
            out = (ctypes.c_int * 4)()
            if query(dcode, n, int(solver == "semiseparable") | 2, out) == 0:
                builds[label]["layout"] = list(out)
                log(f"layout {label}: {out[0]} lanes a member, {out[1]} threads and {out[2]} B "
                    f"of shared memory a block, {out[3]} blocks ({out[3] * out[1] // 32} warps, "
                    f"{out[3] * out[1] // out[0]} members) an SM, "
                    f"{BATCH / (132 * out[3] * out[1] / out[0]):.2f} waves of {BATCH} members")

    # ---- each kernel against the plain version, then the rounds --------------
    out = {}
    for case in args.cases:
        n, solver, iters, dt, per_member, composition = CASES[case]
        composition = composition or fs.SUZUKI4_COMPOSITION
        weights = (ctypes.c_double * len(composition))(*composition)
        fm = forms[case]
        ex = tp.chain(n_links=n, fused_solver=solver, device=dev, dtype=dtype)
        semi = solver == "semiseparable"
        const = torch.tensor([float(v) for t in fm.consts for v in t], dtype=torch.float64,
                             device=dev) if fm.consts is not None else None
        shared_coef = fs.coef_table(fm, dev, dtype)
        built = _build_case(case)
        routes = [label[len(built) + 1:] for label in libs if label.split()[0] == built]
        flags = int(semi) | 2 | (4 if per_member else 0)

        def members(batch, seed):
            """``(forms, state, coef)`` of ``batch`` jittered members: the
            shared table, or per-member masses and gravity drawn from
            ``seed``."""
            if not per_member:
                st = fs.fused_stepper(fm, iters=iters, compensated=True, composition=composition)
                return fm, st.init(cs.jittered_phase(ex, batch, dtype, dev, seed)), None
            rng = np.random.default_rng(seed)
            sysb = ex.system.replace_params(tp.params_from_numpy({
                "masses": 1.0 + 0.05 * rng.standard_normal((batch, n)),
                "lengths": np.ones((batch, n)),
                "gravity": 5.0 + 0.1 * rng.standard_normal(batch)}, device=dev, dtype=dtype))
            fmb = sysb.fused_forms(sysb)
            st = fs.fused_stepper(fmb, iters=iters, compensated=True, composition=composition)
            state, table = st.init(cs.jittered_phase(ex, batch, dtype, dev, seed))
            return fmb, state, table

        def route(name, state, spc, table=None):
            entry, kind = libs[f"{built} {name}"]
            res = torch.empty_like(state)
            stream = torch.cuda.current_stream(dev).cuda_stream
            if kind in ("fused_step", "semisep_wide"):
                coef = table if table is not None else shared_coef
                code = entry(dcode, n, flags, coef.data_ptr(), state.data_ptr(),
                             res.data_ptr(), state.shape[2], dt, iters[0], iters[1], spc,
                             len(composition), weights, stream)
            else:
                code = entry(dcode, 0, 2, const.data_ptr(), state.data_ptr(), res.data_ptr(),
                             state.shape[2], dt, iters[0], iters[1], spc, len(composition),
                             weights, stream)
            if code != 0:
                raise RuntimeError(f"{case} {name}: the kernel returned {code}")
            return res

        rec = out[case] = {"max_err": {}, "bitwise": {}, "ms": {r: [] for r in routes}}
        if not routes:
            log(f"{case}: no kernel built")
            continue
        small_fm, small, small_table = members(CHECK_BATCH, 3)
        state_fm, state, table = members(BATCH, 0)
        # the n = 20 semiseparable builds contract (FMA) as fused_step.cu's
        # part ships: held over the 50 steps chip_smoke.TOL was read at
        steps = SPC if case in N20_CASES else 1
        for where, mfm, mstate, mtable in (("", small_fm, small, small_table),
                                           (" (the timed state)", state_fm, state, table)):
            t0 = time.perf_counter()
            want = fs.fused_step_reference(mfm, mstate, dt, iters=iters, compensated=True,
                                           composition=composition, coef=mtable,
                                           steps_per_call=steps)
            torch.cuda.synchronize()
            b = mstate.shape[2]
            log(f"{case}: the plain version's step on {b} members took "
                f"{time.perf_counter() - t0:.2f} s")
            for name in list(routes):
                got = route(name, mstate, steps, mtable)
                torch.cuda.synchronize()
                worst, errs, failures = cs.compare_states(got, want, args.dtype)
                rec["max_err"][name] = max(rec["max_err"].get(name, 0.0), worst)
                rec["bitwise"][name] = rec["bitwise"].get(name, True) and bool(
                    torch.equal(got, want))
                differ = ((got != want) & ~(got.isnan() & want.isnan())).any(0).any(0)
                log(f"{case}: {name} vs plain, {b} members{where}, {steps} steps: bitwise "
                    f"{bool(torch.equal(got, want))}, "
                    + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                    + f"; {int(differ.sum())} members differ"
                    + (f" (the first {differ.nonzero()[:8, 0].tolist()})" if differ.any() else "")
                    + (" FAILED: " + "; ".join(failures) if failures else ""))
                if failures:
                    rec.setdefault("failed", []).append(name)
                    routes.remove(name)
                    del rec["ms"][name]
        if not routes:
            continue
        reps = {}
        for name in routes:
            est, _ = time_queued(lambda: route(name, state, SPC, table), 3)
            reps[name] = max(10, min(100, round(300 / max(est, 1e-3))))
        for r in range(args.pairs):
            order = routes[r % len(routes):] + routes[:r % len(routes)]
            for name in order:
                t, _ = time_queued(lambda: route(name, state, SPC, table), reps[name])
                rec["ms"][name].append(t)
            log(f"{case}: round {r}: " + ", ".join(f"{k} {v[-1]:.4f} ms"
                                                   for k, v in rec["ms"].items()))
        rec["median_ms"] = {k: statistics.median(v) for k, v in rec["ms"].items()}
        rec["spread"] = {k: (max(v) - min(v)) / statistics.median(v)
                         for k, v in rec["ms"].items()}
        log(f"{case}: medians " + ", ".join(
            f"{k} {v:.4f} ms (spread {rec['spread'][k]:.4f})"
            for k, v in rec["median_ms"].items()) + f"; launches a window {reps}")
        del state, small, want, table, small_table
    log(json.dumps({"card": card, "dtype": args.dtype, "builds": builds, "cases": out}))
    return 1 if any(rec.get("failed") for rec in out.values()) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
