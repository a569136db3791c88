#!/usr/bin/env python3
"""Build and time the batched factor (K2b) and solve (K2c) at several lanes a
member and block sizes, on one card.

    python3 scripts/k2_sweep.py [--lanes 1,2,4,8,32] [--threads 32,64,128,256]

Each variant ``G:T`` is a copy of ``hamilton_tpu_torch/csrc/`` under
``hamilton_tpu_torch/_build/k2_sweep/`` with every entry of the source's K2b
and K2c tables (``kFactorShape``, ``kSubstituteShape`` in
``csrc/batched_spd.cu``) set to G lanes a member and T threads a block, built
with the package's nvcc flags (all variants at once, one nvcc each); the
package itself is not touched.  The script then loads every variant's
library into one process and, through its C entries, for n = 3, 20 and 32,
float32 and float64, B = 1000 and 16384 (random SPD K and b from
``chip_smoke.k2_inputs``):

- holds L and x against ``cholesky_plain`` and ``cho_solve_plain`` on the
  same inputs, bit for bit (the script ends with exit code 1 if any
  differs);
- times one call, device ms from CUDA events around 50 calls queued behind a
  held stream (``utils.profiling.time_queued``): on one operand set, and at
  B = 16384 also on four sets in turn (at n = 20 and 32 more than the 50 MB
  L2 in all: the time of operands that L2 does not hold).

Prints the card's name and power limit, each variant's build seconds, its
registers and spills, a line per variant, kernel, n, dtype and B (the
members a block that ``launch_tiles`` picks, the blocks, the ms), the fastest
variant for each kernel, n and dtype at B = 16384, and a last line of JSON:
``{"card": ..., "rows": [...], "best": {...}, "failures": [...]}``.
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "hamilton_tpu_torch" / "csrc"
WORK = ROOT / "hamilton_tpu_torch" / "_build" / "k2_sweep"
SIZES, BATCHES, ROTATE, REPS, SMS = (3, 20, 32), (1000, 16384), 4, 50, 132
SMEM_PER_BLOCK = 232448  # csrc/batched_spd.cu's kSmemPerBlockMax


def variant_source(lanes: int, threads: int) -> Path:
    """A copy of ``csrc/`` with both tables set to (lanes, threads)."""
    where = WORK / f"G{lanes}_T{threads}"
    if where.exists():
        shutil.rmtree(where)
    shutil.copytree(CSRC, where)
    path = where / "batched_spd.cu"
    shape = "{%d, %d}" % (lanes, threads)
    table = "{{%s}, {%s}}" % ((", ".join([shape] * 3),) * 2)
    text, count = re.subn(r"(k(?:Factor|Substitute)Shape\[2\]\[3\] = )\{.*?\};",
                          lambda m: f"{m.group(1)}{table};", path.read_text(), flags=re.S)
    if count != 2:
        raise RuntimeError(f"{path}: the K2b and K2c tables found {count} times, expected 2")
    path.write_text(text)
    return path


def build(src: Path) -> dict:
    from hamilton_tpu_torch import kernels

    lib = src.parent / "libbatched_spd.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    return {"lib": lib, "seconds": time.perf_counter() - t0, "log": proc.stdout + proc.stderr}


def members_a_block(lanes, threads, n, dtype_bytes, batch, solve):
    """The members a block ``launch_tiles`` picks (its rule, restated)."""
    member_bytes = ((n * n) | 1) * dtype_bytes + ((n | 1) * dtype_bytes if solve else 0)
    return max(1, min(threads // lanes, SMEM_PER_BLOCK // member_bytes, batch // SMS))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", default="1,2,4,8,32")
    ap.add_argument("--threads", default="32,64,128,256")
    args = ap.parse_args(argv)
    variants = [(g, t) for g in map(int, args.lanes.split(","))
                for t in map(int, args.threads.split(",")) if t >= g]
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.ops.batched_spd import cho_solve_plain, cholesky_plain
    from hamilton_tpu_torch.utils.profiling import time_queued

    card = cs.card_line()
    print(card, flush=True)
    sources = {v: variant_source(*v) for v in variants}
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        built = dict(zip(variants, pool.map(build, sources.values())))
    libs = {}
    for v in variants:
        regs = cs.ptxas_report(built[v]["log"], cs._K2_RE, cs._k2_label)
        tiles = [r for r in regs if "lanes" in r[0] or "one thread" in r[0]]
        print(f"build G={v[0]} T={v[1]}: {built[v]['seconds']:.1f} s; "
              + "; ".join(f"{name} {r} registers, spills {st}/{ld} B"
                          for name, r, st, ld in tiles), flush=True)
        lib = ctypes.CDLL(str(built[v]["lib"]))
        for fn, argtypes in kernels._SIGNATURES["batched_spd"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[v] = lib

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows, failures = [], []
    for n in SIZES:
        for dtype in (torch.float32, torch.float64):
            dname, code = str(dtype).split(".")[-1], int(dtype == torch.float64)
            for batch in BATCHES:
                sets = []
                for s in range(ROTATE if batch == max(BATCHES) else 1):
                    k, _, b = cs.k2_inputs(batch, n, dtype, dev, 100 * n + batch + s)
                    low_want = cholesky_plain(k)
                    sets.append((k, b, low_want, cho_solve_plain(low_want, b)))
                low, x = torch.empty_like(sets[0][0]), torch.empty_like(sets[0][1])
                for v, lib in libs.items():
                    def factor(s):
                        return lib.hamilton_spd_factor(code, 0, s[0].data_ptr(), low.data_ptr(),
                                                       batch, n, 0, stream)

                    def solve(s):
                        return lib.hamilton_spd_substitute(code, s[2].data_ptr(), s[1].data_ptr(),
                                                           x.data_ptr(), batch, n, stream)

                    for kind, call, out, want in (("K2b", factor, low, 2), ("K2c", solve, x, 3)):
                        if call(sets[0]) != 0:
                            raise RuntimeError(f"G={v[0]} T={v[1]} {kind} n={n} {dname} "
                                               f"B={batch}: launch failed")
                        torch.cuda.synchronize()
                        equal = torch.equal(out, sets[0][want])
                        if not equal:
                            err = float((out - sets[0][want]).abs().max())
                            failures.append(f"G={v[0]} T={v[1]} {kind} n={n} {dname} "
                                            f"B={batch}: differs from plain by {err:.3e}")
                            print(failures[-1], flush=True)
                        ms, _ = time_queued(lambda: call(sets[0]), REPS)
                        turn = iter(range(10**9))
                        rot = (time_queued(lambda: call(sets[next(turn) % len(sets)]), REPS)[0]
                               if len(sets) > 1 else None)
                        m = members_a_block(*v, n, dtype.itemsize, batch, kind == "K2c")
                        row = {"kernel": kind, "lanes": v[0], "threads": v[1], "n": n,
                               "dtype": dname, "batch": batch, "members": m,
                               "blocks": -(-batch // m), "ms": ms, "ms_rotating": rot,
                               "equal": equal}
                        rows.append(row)
                        print(f"{kind} G={v[0]:2d} T={v[1]:3d} n={n:2d} {dname} B={batch:5d}: "
                              f"{m} members x {row['blocks']} blocks, {ms:.5f} ms"
                              + ("" if rot is None else f", rotating {rot:.5f} ms"), flush=True)
    best = {}
    for kind in ("K2b", "K2c"):
        for n in SIZES:
            for dname in ("float32", "float64"):
                cand = [r for r in rows if (r["kernel"], r["n"], r["dtype"], r["batch"])
                        == (kind, n, dname, max(BATCHES))]
                top = min(cand, key=lambda r: r["ms"])
                best[f"{kind} n={n} {dname}"] = [top["lanes"], top["threads"], top["ms"]]
                small = {(r["lanes"], r["threads"]): r["ms"] for r in rows
                         if (r["kernel"], r["n"], r["dtype"], r["batch"])
                         == (kind, n, dname, min(BATCHES))}
                print(f"best {kind} n={n} {dname} at B={max(BATCHES)}: G={top['lanes']} "
                      f"T={top['threads']} {top['ms']:.5f} ms (B={min(BATCHES)}: "
                      f"{small[(top['lanes'], top['threads'])]:.5f} ms; fastest there "
                      f"{min(small.values()):.5f})", flush=True)
    print(json.dumps({"card": card, "rows": rows, "best": best, "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
