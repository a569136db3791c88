#!/usr/bin/env python3
"""Build and time the batched solves (K2a-K2e) at several lanes a member and
block sizes, on one card.

    python3 scripts/k2_sweep.py [--lanes 1,2,4,8,16,32] [--threads 32,64,128,256]

Each variant ``G:T:F`` is a copy of ``hamilton_tpu_torch/csrc/`` under
``hamilton_tpu_torch/_build/k2_sweep/`` with the source's shape tables
(``csrc/batched_spd.cu``) set by :func:`patch_tables`: K2a, K2b and K2c
(``kSolveShape``, ``kFactorShape``, ``kSubstituteShape``) to G lanes a member
and T threads a block; K2d and K2e (``kJacSolveShape``, ``kJacFactorShape``)
to G lanes forming K (in a class where a lane's sums would pass
``kMaxJacSums``, the fewest lanes above G that keep them within it),
factoring and solving on one thread (``F = one``) or on those lanes
(``F = lanes``).  The variants build 16 at a time, one nvcc each, with the
package's flags; the package itself is not touched.
The script then loads every variant's library into one process and, through
its C entries, for n = 3, 20 and 32 (the J entries at m = n and 2n),
float32 and float64, B = 1000 and 16384 (random operands from
``chip_smoke.k2_inputs``):

- holds each output against its plain version on the same inputs, bit for
  bit (the script ends with exit code 1 if any differs);
- times one call, device ms from CUDA events around 50 calls queued behind a
  held stream (``utils.profiling.time_queued``): on one operand set, and at
  B = 16384 also on four sets in turn (more than the 50 MB L2 at n = 20).

K2a, K2b and K2c are timed in the ``F = one`` variants only (``F`` changes
no table of theirs).  Prints the card's name and power limit, each variant's
build seconds, its registers and spills, a line per variant, kernel, n, m,
dtype and B (the shape the source took, the members a block that
``launch_tiles`` picks, the blocks, the ms), the fastest shape for each
kernel, n, m and dtype at B = 16384, and a last line of JSON:
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
_TILE_TABLES = ("kSolveShape", "kFactorShape", "kSubstituteShape")


def _constant(text: str, name: str) -> str:
    m = re.search(rf"{name}(?:\[\d+\])? = \{{?([^;{{}}]*)\}}?;", text)
    if m is None:
        raise RuntimeError(f"batched_spd.cu: no constant {name}")
    return m.group(1)


def jac_sums(nmax: int, lanes: int) -> int:
    """The sums a lane holds forming K for n <= nmax (``jac_sums``)."""
    return sum(i // lanes + 1 for i in range(nmax))


def jac_lanes(nmax: int, lanes: int, most: int) -> int:
    """The fewest lanes, ``lanes`` or a power of two above, whose sums stay
    within ``most`` for n <= nmax."""
    while jac_sums(nmax, lanes) > most:
        lanes *= 2
    return lanes


def patch_tables(text: str, lanes: int, threads: int, factor_on_lanes):
    """``batched_spd.cu``'s text with its tables set to a variant:
    ``(text, [(lanes, factor lanes, threads)] of the J tables by class)``.
    ``factor_on_lanes``: one bool for every class, or one a class."""
    class_max = [int(v) for v in _constant(text, "kClassMaxN").split(",")]
    if isinstance(factor_on_lanes, bool):
        factor_on_lanes = (factor_on_lanes,) * len(class_max)
    most = int(_constant(text, "kMaxJacSums"))
    shape = "{%d, %d}" % (lanes, threads)
    table = "{{%s}, {%s}}" % ((", ".join([shape] * 3),) * 2)
    text, count = re.subn(r"(constexpr Shape (%s)\[2\]\[3\] = )\{.*?\};" % "|".join(_TILE_TABLES),
                          lambda m: f"{m.group(1)}{table};", text, flags=re.S)
    jac = []
    for nmax, on_lanes in zip(class_max, factor_on_lanes):
        g = jac_lanes(nmax, lanes, most)
        jac.append((g, g if on_lanes else 1, max(threads, g)))
    row = ", ".join("{%d, %d, %d}" % s for s in jac)
    text, jcount = re.subn(r"(constexpr JacShape kJac(?:Solve|Factor)Shape\[2\]\[3\] = )\{.*?\};",
                           lambda m: f"{m.group(1)}{{{{{row}}}, {{{row}}}}};", text, flags=re.S)
    if count != len(_TILE_TABLES) or jcount != 2:
        raise RuntimeError(f"batched_spd.cu: the shape tables found {count} + {jcount} times, "
                           f"expected {len(_TILE_TABLES)} + 2")
    return text, jac


def variant_source(lanes: int, threads: int, factor_on_lanes: bool):
    """A copy of ``csrc/`` with the tables set to the variant: ``(path,
    the J tables by class)``."""
    where = WORK / f"G{lanes}_T{threads}_{'lanes' if factor_on_lanes else 'one'}"
    if where.exists():
        shutil.rmtree(where)
    shutil.copytree(CSRC, where)
    path = where / "batched_spd.cu"
    text, jac = patch_tables(path.read_text(), lanes, threads, factor_on_lanes)
    path.write_text(text)
    return path, jac


def build(src: Path) -> dict:
    from hamilton_tpu_torch import kernels

    lib = src.parent / "libbatched_spd.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    return {"lib": lib, "seconds": time.perf_counter() - t0, "log": proc.stdout + proc.stderr}


def members_a_block(lanes, threads, member_values, dtype_bytes, batch):
    """The members a block ``launch_tiles`` picks (its rule, restated)."""
    return max(1, min(threads // lanes, SMEM_PER_BLOCK // (member_values * dtype_bytes),
                      batch // SMS))


def member_values(kind, n, m):
    """Shared values a member takes (``*_class`` in the source)."""
    odd = lambda v: v | 1  # noqa: E731
    if kind in ("K2d", "K2e"):
        rows = max(1, min(m, 128 // n))  # kChunkValues
        return max(odd(n * n), 2 * odd(rows * n)) + (odd(n) if kind == "K2d" else 0)
    return odd(n * n) + (odd(n) if kind != "K2b" else 0)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", default="1,2,4,8,16,32")
    ap.add_argument("--threads", default="32,64,128,256")
    args = ap.parse_args(argv)
    variants = [(g, t, f) for g in map(int, args.lanes.split(","))
                for t in map(int, args.threads.split(",")) if t >= g
                for f in ((False, True) if g > 1 else (False,))]
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.ops import batched_spd as bs
    from hamilton_tpu_torch.utils.profiling import time_queued

    card = cs.card_line()
    print(card, flush=True)
    sources = {v: variant_source(*v) for v in variants}
    with ThreadPoolExecutor(max_workers=min(len(variants), 16)) as pool:
        built = dict(zip(variants, pool.map(build, [p for p, _ in sources.values()])))
    libs = {}
    for v in variants:
        regs = cs.ptxas_report(built[v]["log"], cs._K2_RE, cs._k2_label)
        print(f"build G={v[0]} T={v[1]} F={'lanes' if v[2] else 'one'}: "
              f"{built[v]['seconds']:.1f} s; J tables {sources[v][1]}; "
              + "; ".join(f"{name} {r} registers, spills {st}/{ld} B"
                          for name, r, st, ld in regs), flush=True)
        lib = ctypes.CDLL(str(built[v]["lib"]))
        for fn, argtypes in kernels._SIGNATURES["batched_spd"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[v] = lib

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rows, failures, seen = [], [], set()

    def run(v, kind, n, m, dname, batch, sets, call, out, want):
        """Check and time one kernel of variant v, unless a variant before
        it gave this kernel the same shape."""
        jac = kind in ("K2d", "K2e")
        lanes, factor_lanes, threads = (sources[v][1][bs_class(n)] if jac
                                        else (v[0], v[0], v[1]))
        key = (kind, lanes, factor_lanes, threads, n, m, dname, batch)
        if key in seen:
            return
        seen.add(key)
        if call(sets[0]) != 0:
            raise RuntimeError(f"{v} {kind} n={n} {dname} B={batch}: launch failed")
        torch.cuda.synchronize()
        equal = bool(((out == sets[0][want]) | (out.isnan() & sets[0][want].isnan())).all())
        if not equal:
            err = float((out - sets[0][want]).abs().max())
            failures.append(f"{v} {kind} n={n} m={m} {dname} B={batch}: differs from plain "
                            f"by {err:.3e}")
            print(failures[-1], flush=True)
        ms, _ = time_queued(lambda: call(sets[0]), REPS)
        turn = iter(range(10**9))
        rot = (time_queued(lambda: call(sets[next(turn) % len(sets)]), REPS)[0]
               if len(sets) > 1 else None)
        mb = members_a_block(lanes, threads, member_values(kind, n, m), sets[0][1].element_size(),
                             batch)
        row = {"kernel": kind, "lanes": lanes, "factor_lanes": factor_lanes,
               "threads": threads, "n": n, "m": m, "dtype": dname, "batch": batch,
               "members": mb, "blocks": -(-batch // mb), "ms": ms, "ms_rotating": rot,
               "equal": equal}
        rows.append(row)
        print(f"{kind} G={lanes:2d} F={factor_lanes:2d} T={threads:3d} n={n:2d} m={m or '-':>2} "
              f"{dname} B={batch:5d}: {mb} members x {row['blocks']} blocks, {ms:.5f} ms"
              + ("" if rot is None else f", rotating {rot:.5f} ms"), flush=True)

    def bs_class(n):
        return 0 if n <= 8 else 1 if n <= 24 else 2

    for n in SIZES:
        for dtype in (torch.float32, torch.float64):
            dname, code = str(dtype).split(".")[-1], int(dtype == torch.float64)
            for batch in BATCHES:
                nsets = ROTATE if batch == max(BATCHES) else 1
                inputs = [cs.k2_inputs(batch, n, dtype, dev, 100 * n + batch + s)
                          for s in range(nsets)]
                sets = []
                for k, _, b in inputs:
                    low_want = bs.cholesky_plain(k)
                    sets.append((k, b, low_want, bs.cho_solve_plain(low_want, b),
                                 bs.spd_solve_plain(k, b)))
                low, x = torch.empty_like(sets[0][0]), torch.empty_like(sets[0][1])
                for v, lib in libs.items():
                    if v[2]:
                        continue

                    def solve(s, lib=lib):
                        return lib.hamilton_spd_solve(code, 0, s[0].data_ptr(), s[1].data_ptr(),
                                                      x.data_ptr(), batch, n, 0, stream)

                    def factor(s, lib=lib):
                        return lib.hamilton_spd_factor(code, 0, s[0].data_ptr(), low.data_ptr(),
                                                       batch, n, 0, stream)

                    def substitute(s, lib=lib):
                        return lib.hamilton_spd_substitute(code, s[2].data_ptr(), s[1].data_ptr(),
                                                           x.data_ptr(), batch, n, stream)

                    for kind, call, out, want in (("K2a", solve, x, 4), ("K2b", factor, low, 2),
                                                  ("K2c", substitute, x, 3)):
                        run(v, kind, n, 0, dname, batch, sets, call, out, want)
                for m in (n, 2 * n):
                    jsets = []
                    for s, (_, js, b) in enumerate(inputs):
                        if m == n:
                            js = cs.k2_inputs(batch, n, dtype, dev, 100 * n + batch + s, m=n)[1]
                        jsets.append((js, b, bs.cholesky_jac_plain(js),
                                      bs.spd_solve_jac_plain(js, b)))
                    for v, lib in libs.items():

                        def jac_solve(s, lib=lib, m=m):
                            return lib.hamilton_spd_solve(code, 1, s[0].data_ptr(),
                                                          s[1].data_ptr(), x.data_ptr(), batch,
                                                          n, m, stream)

                        def jac_factor(s, lib=lib, m=m):
                            return lib.hamilton_spd_factor(code, 1, s[0].data_ptr(),
                                                           low.data_ptr(), batch, n, m, stream)

                        for kind, call, out, want in (("K2d", jac_solve, x, 3),
                                                      ("K2e", jac_factor, low, 2)):
                            run(v, kind, n, m, dname, batch, jsets, call, out, want)
    best = {}
    for kind in ("K2a", "K2b", "K2c", "K2d", "K2e"):
        for n in SIZES:
            for m in ((n, 2 * n) if kind in ("K2d", "K2e") else (0,)):
                for dname in ("float32", "float64"):
                    cand = {}
                    for r in rows:
                        if (r["kernel"], r["n"], r["m"], r["dtype"]) == (kind, n, m, dname):
                            shape = (r["lanes"], r["factor_lanes"], r["threads"])
                            cand.setdefault(shape, {})[r["batch"]] = r["ms"]
                    top = min(cand, key=lambda s: cand[s][max(BATCHES)])
                    small = min(cand, key=lambda s: cand[s][min(BATCHES)])
                    best[f"{kind} n={n} m={m} {dname}"] = [*top, cand[top][max(BATCHES)]]
                    print(f"best {kind} n={n} m={m} {dname} at B={max(BATCHES)}: G={top[0]} "
                          f"F={top[1]} T={top[2]} {cand[top][max(BATCHES)]:.5f} ms "
                          f"(B={min(BATCHES)}: {cand[top][min(BATCHES)]:.5f} ms; fastest there "
                          f"G={small[0]} F={small[1]} T={small[2]} "
                          f"{cand[small][min(BATCHES)]:.5f})", flush=True)
    print(json.dumps({"card": card, "rows": rows, "best": best, "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
