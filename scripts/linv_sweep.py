#!/usr/bin/env python3
"""Build and time K1's L⁻¹ form at several layouts, on one card.

    python3 scripts/linv_sweep.py [VARIANT ...]

A VARIANT is ``G20:G5`` (default ``1:1 2:2 4:2 8:8 16:2``): the lanes a
member at n = 20 and at n = 5, then optionally ``o`` to call the factor,
solve and dH/dq routines out of line at both sizes (the source inlines
them at n <= 8).  Each variant is a copy of the package under
``hamilton_tpu_torch/_build/linv_sweep/`` whose ``csrc/chain_variants.cu``
has those constants changed (``kLinvLanesLong``, ``kLinvLanesShort``,
``kLinvInlineUpTo``); the package itself is not touched.  The script builds
the float32 L⁻¹ parts of every variant at once (one nvcc a part), then, one
variant at a time in a fresh process, reads for n = 20 and n = 5 (float32,
Kahan, (2,0), shared table, dt = 5e-4):

- nvcc's ``-Xptxas -v`` registers and spill bytes of that instantiation;
- the layout the built library reports (``kernels.linv_layout``): threads
  and dynamic shared memory a block, and the blocks an SM that the card
  holds at once, as warps an SM and the waves 16384 members take;
- the kernel against its plain version on 1000 members over 5 steps: equal
  bit for bit, or the script fails;
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
WORK = PACKAGE / "_build" / "linv_sweep"
BATCH, SPC, REPS, CHECK_BATCH, CHECK_SPC, SMS = 16384, 50, 20, 1000, 5, 132
CODES = {20: 2, 5: 3}  # n: case of csrc/chain_variants.cu


def _constants(variant: str) -> dict:
    """The source's constants that ``variant`` sets."""
    m = re.fullmatch(r"(\d+):(\d+)(o?)", variant)
    if m is None:
        raise ValueError(f"not a variant: {variant!r}")
    out = {"kLinvLanesLong": int(m[1]), "kLinvLanesShort": int(m[2])}
    if m[3]:
        out["kLinvInlineUpTo"] = 0
    return out


def _copy(variant: str) -> Path:
    """A copy of the package with the variant's constants in its source;
    the directory to put first on ``sys.path``."""
    where = WORK / variant.replace(":", "_")
    pkg = where / "hamilton_tpu_torch"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = pkg / "csrc" / "chain_variants.cu"
    text = src.read_text()
    for name, value in _constants(variant).items():
        text, count = re.subn(rf"\b{name} = \d+", f"{name} = {value}", text)
        if count != 1:
            raise RuntimeError(f"{src}: {name} set {count} times, expected once")
    src.write_text(text)
    return where


def _kernels(where: str):
    sys.path[:0] = [where, str(ROOT)]
    from hamilton_tpu_torch import kernels

    if not Path(kernels.__file__).is_relative_to(where):
        raise RuntimeError(f"imported {kernels.__file__}, not the copy in {where}")
    return kernels


def build(where: str) -> dict:
    kernels = _kernels(where)
    part_of = kernels.PARTS["chain_variants"][1]
    b = kernels.build("chain_variants", parts=tuple(part_of(0, code) for code in CODES.values()))
    return {"seconds": b.seconds, "part_seconds": list(b.part_seconds), "log": b.log}


def time_variant(variant: str, where: str, log: str) -> list:
    kernels = _kernels(where)
    import numpy as np
    import torch

    import hamilton_tpu_torch as tp
    from chip_smoke import _VARIANT_RE, _variant_label, ptxas_report
    from hamilton_tpu_torch.ops.fused_step import (
        coef_table, fused_step_kernel, fused_step_reference, fused_stepper,
    )
    from hamilton_tpu_torch.utils.profiling import time_queued

    regs = {name: (r, st, ld) for name, r, st, ld in
            ptxas_report(log, _VARIANT_RE, _variant_label)}
    dev = torch.device("cuda")
    rows = []
    for n, code in CODES.items():
        ex = tp.chain(n_links=n, fused_solver="linv", device=dev, dtype=torch.float32)
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
        if not torch.equal(got, want):
            raise AssertionError(f"{variant} n={n}: kernel differs from plain by "
                                 f"{float((got - want).abs().max()):.3e}")
        before = kernels.chain_variants_launch.launches
        fused_step_kernel(forms, state, 5e-4, steps_per_call=SPC, **kw)
        ms, _ = time_queued(lambda: fused_step_kernel(forms, state, 5e-4, steps_per_call=SPC,
                                                      **kw), REPS)
        launches = kernels.chain_variants_launch.launches - before
        r, st, ld = regs[f"float linv n={n} kahan"]
        lanes, block, smem, blocks = kernels.linv_layout(0, code)
        rows.append({"variant": variant, "n": n, "G": lanes, "ms": ms, "registers": r,
                     "spill_stores": st, "spill_loads": ld, "block": block,
                     "smem_bytes": smem, "warps_per_sm": blocks * block // 32,
                     "waves": BATCH / (blocks * block // lanes * SMS), "launches": launches})
    return rows


def main(argv) -> int:
    if argv[:1] == ["--build"]:
        print(json.dumps(build(argv[1])), flush=True)
        return 0
    if argv[:1] == ["--time"]:
        print(json.dumps(time_variant(argv[1], argv[2], Path(argv[3]).read_text())), flush=True)
        return 0
    variants = argv or ["1:1", "2:2", "4:2", "8:8", "16:2"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    copies = {v: _copy(v) for v in variants}
    procs = {v: subprocess.Popen([sys.executable, __file__, "--build", str(copies[v])],
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
                  f"{row['waves']:.2f} waves; equal to plain", flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0 if len(rows) == 2 * len(variants) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
