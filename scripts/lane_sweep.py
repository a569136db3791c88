#!/usr/bin/env python3
"""Build and time K1's L⁻¹ form at several lanes a member, beside the
one-thread semiseparable and Möbius kernels, on one card.

    python3 scripts/lane_sweep.py [VARIANT ...]

A VARIANT is ``FORM:G20:G5`` (default ``linv:4:2 linv:2:2 linv:8:2
semiseparable:0:0``): ``linv`` (``csrc/chain_variants.cu``) with G20 and G5
the lanes a member at n = 20 and at n = 5 (powers of two), optionally
followed by ``o`` to call its factor, solve and dH/dq routines out of line
at both sizes (the source inlines them at n <= 8); or ``semiseparable:0:0``
(``csrc/fused_step.cu``: at n = 20 its link split, ``csrc/
semisep_wide.cuh``, at n = 5 one thread a member) or ``mobius:0:0``
(``csrc/chain_variants.cu``, one thread a member), the kernels as shipped,
the first optionally followed by ``f`` to
build without FMA contraction (``-fmad=false``, which ``chain_variants.cu``
always has).  Each variant is a copy of the package under
``hamilton_tpu_torch/_build/lane_sweep/`` with those constants changed in
its sources (``kLinvLanesLong``, ``kLinvLanesShort``, ``kLaneInlineUpTo`` in
``csrc/chain_lanes.cuh``) and its flags in ``kernels.SOURCE_FLAGS``; the
package itself is not touched.
The script builds the float32 parts of the form of every variant at once
(one nvcc a part), then, one variant at a time in a fresh process, reads for
n = 20 and n = 5 (float32, Kahan, (2,0), shared table, dt = 5e-4):

- nvcc's ``-Xptxas -v`` registers and spill bytes of that instantiation;
- the layout the built library reports (``kernels.lane_layout``): lanes,
  threads and dynamic shared memory a block, and the blocks an SM that the
  card holds at once, as warps an SM and the waves 16384 members take;
- the kernel against its plain version on 1000 members over 50 steps:
  equal bit for bit where the source has no FMA contraction, else within
  ``chip_smoke.py``'s phase 1 limits (``semisep_tol``), or the script fails;
- the device ms of one 50-step launch at 16384 members, from CUDA events
  around 20 launches queued behind a held stream
  (``utils.profiling.time_queued``).

Prints the card's name and power limit, each variant's build seconds, a
line per variant and size, and a last line of JSON:
``{"card": ..., "rows": [...]}``.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "hamilton_tpu_torch"
WORK = PACKAGE / "_build" / "lane_sweep"
BATCH, SPC, REPS, CHECK_BATCH, CHECK_SPC, SMS = 16384, 50, 20, 1000, 50, 132
# form: (source, {n: code of the source's dispatch})
FORMS = {"semiseparable": ("fused_step", {20: 20, 5: 5}),
         "mobius": ("chain_variants", {20: 0, 5: 1}),
         "linv": ("chain_variants", {20: 2, 5: 3})}
DEFAULT = ["linv:4:2", "linv:2:2", "linv:8:2", "semiseparable:0:0"]


def _parse(variant: str):
    """``(form, {file: {constant: value}}, without FMA contraction)`` of a
    variant."""
    m = re.fullmatch(r"(linv):(\d+):(\d+)(o?)|(semiseparable):0:0(f?)|(mobius):0:0", variant)
    if m is None:
        raise ValueError(f"not a variant: {variant!r}")
    if m[1]:
        consts = {"csrc/chain_variants.cu": {"kLinvLanesLong": int(m[2]),
                                             "kLinvLanesShort": int(m[3])}}
        if m[4]:
            consts["csrc/chain_lanes.cuh"] = {"kLaneInlineUpTo": 0}
        return "linv", consts, False
    return m[5] or m[7], {}, bool(m[6])


def _copy(variant: str) -> Path:
    """A copy of the package with the variant's constants in its sources;
    the directory to put first on ``sys.path``."""
    form, consts, no_fma = _parse(variant)
    where = WORK / variant.replace(":", "_")
    pkg = where / "hamilton_tpu_torch"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, values in consts.items():
        path = pkg / rel
        text = path.read_text()
        for name, value in values.items():
            text, count = re.subn(rf"\b{name} = \d+", f"{name} = {value}", text)
            if count != 1:
                raise RuntimeError(f"{path}: {name} set {count} times, expected once")
        path.write_text(text)
    if no_fma:
        path = pkg / "kernels" / "__init__.py"
        text, count = re.subn(r"SOURCE_FLAGS = \{", 'SOURCE_FLAGS = {"fused_step": ("-fmad=false",), ',
                              path.read_text())
        if count != 1:
            raise RuntimeError(f"{path}: SOURCE_FLAGS not found once")
        path.write_text(text)
    return where


def _kernels(where: str):
    sys.path[:0] = [where, str(ROOT)]
    from hamilton_tpu_torch import kernels

    if not Path(kernels.__file__).is_relative_to(where):
        raise RuntimeError(f"imported {kernels.__file__}, not the copy in {where}")
    return kernels


def build(variant: str, where: str) -> dict:
    kernels = _kernels(where)
    source, codes = FORMS[_parse(variant)[0]]
    part_of = kernels.PARTS[source][1]
    b = kernels.build(source, parts=tuple(part_of(0, code, source == "fused_step")
                                           for code in codes.values()))
    return {"seconds": b.seconds, "part_seconds": list(b.part_seconds), "log": b.log}


def time_variant(variant: str, where: str, log: str) -> list:
    kernels = _kernels(where)
    import numpy as np
    import torch

    import hamilton_tpu_torch as tp
    import chip_smoke as cs
    from hamilton_tpu_torch.ops.fused_step import (
        coef_table, fused_step_kernel, fused_step_reference, fused_stepper,
    )
    from hamilton_tpu_torch.utils.profiling import time_queued

    form, _, no_fma = _parse(variant)
    source, codes = FORMS[form]
    pattern, label = ((cs._KERNEL_RE, cs._k1_label) if source == "fused_step"
                      else (cs._VARIANT_RE, cs._variant_label))
    regs = {name: (r, st, ld) for name, r, st, ld in cs.ptxas_report(log, pattern, label)}
    exact = source == "chain_variants" or no_fma
    dev = torch.device("cuda")
    rows = []
    for n, code in codes.items():
        ex = tp.chain(n_links=n, fused_solver=form, device=dev, dtype=torch.float32)
        forms = ex.system.fused_forms(ex.system)
        rng = np.random.default_rng(0)
        q = ex.init_phase.q.cpu().numpy() + 0.01 * rng.standard_normal((BATCH, n))
        ph = tp.Phase(torch.tensor(q, dtype=torch.float32, device=dev),
                      ex.init_phase.p.to(torch.float32).expand(BATCH, n).contiguous())
        state = fused_stepper(forms, iters=(2, 0), compensated=True).init(ph)
        kw = dict(iters=(2, 0), compensated=True, coef=coef_table(forms, dev, torch.float32))
        small = state[:, :, :CHECK_BATCH].contiguous()
        got = fused_step_kernel(forms, small, 5e-4, steps_per_call=CHECK_SPC, **kw)
        want = fused_step_reference(forms, small, 5e-4, steps_per_call=CHECK_SPC, **kw)
        if exact and not torch.equal(got, want):
            raise AssertionError(f"{variant} n={n}: kernel differs from plain by "
                                 f"{float((got - want).abs().max()):.3e}")
        _, errs, failures = cs.compare_states(got, want, "float32",
                                              cs.semisep_tol(n, "float32"))
        if failures:
            raise AssertionError(f"{variant} n={n}: " + "; ".join(failures))
        before = kernels.launch_counts()
        fused_step_kernel(forms, state, 5e-4, steps_per_call=SPC, **kw)
        ms, _ = time_queued(lambda: fused_step_kernel(forms, state, 5e-4, steps_per_call=SPC,
                                                      **kw), REPS)
        launches = sum(kernels.launch_counts().values()) - sum(before.values())
        name = (f"float n={n} semiseparable kahan" if source == "fused_step"
                else f"float {form} n={n} kahan")
        r, st, ld = regs[name]
        lanes, block, smem, blocks = kernels.lane_layout(source, 0, code)
        rows.append({"variant": variant, "n": n, "G": lanes, "ms": ms, "registers": r,
                     "spill_stores": st, "spill_loads": ld, "block": block,
                     "smem_bytes": smem, "warps_per_sm": blocks * block // 32,
                     "waves": BATCH / (blocks * block // lanes * SMS), "launches": launches,
                     "equal": bool(torch.equal(got, want)), "q_err": errs["q"]})
    return rows


def main(argv) -> int:
    if argv[:1] == ["--build"]:
        print(json.dumps(build(argv[1], argv[2])), flush=True)
        return 0
    if argv[:1] == ["--time"]:
        print(json.dumps(time_variant(argv[1], argv[2], Path(argv[3]).read_text())), flush=True)
        return 0
    variants = argv or DEFAULT
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    copies = {v: _copy(v) for v in variants}
    procs = {v: subprocess.Popen([sys.executable, __file__, "--build", v, str(copies[v])],
                                 text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for v in variants}
    logs = {}
    for v, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            print(f"build {v} failed:\n{err[-4000:]}", flush=True)
            continue
        res = json.loads(out.strip().splitlines()[-1])
        logs[v] = copies[v] / "ptxas.log"
        logs[v].write_text(res["log"])
        print(f"build {v}: {res['seconds']:.1f} s (parts n=20 {res['part_seconds'][0]:.1f} s, "
              f"n=5 {res['part_seconds'][1]:.1f} s)", flush=True)
    rows = []
    for v, log in logs.items():
        res = subprocess.run([sys.executable, __file__, "--time", v, str(copies[v]), str(log)],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(f"timing {v} failed:\n{res.stderr[-4000:]}", flush=True)
            continue
        for row in json.loads(res.stdout.strip().splitlines()[-1]):
            rows.append(row)
            print(f"{v} n={row['n']} G={row['G']}: {row['ms']:.4f} ms a launch, "
                  f"{row['registers']} registers, spills {row['spill_stores']}/"
                  f"{row['spill_loads']} B, block {row['block']}, shared "
                  f"{row['smem_bytes']} B, {row['warps_per_sm']} warps an SM, "
                  f"{row['waves']:.2f} waves; "
                  + ("equal to plain" if row["equal"] else f"|q| within {row['q_err']:.2e} "
                     "of plain"), flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0 if len(rows) == 2 * len(variants) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
