#!/usr/bin/env python3
"""What ptxas gives K1's float64 instantiations, under other flags.

    python3 scripts/ptxas_registers.py [--variants NAME,...] [--cap 900] [UNIT ...]

UNIT is ``fused_step`` (``csrc/fused_step.cu``'s float64 part of the
semiseparable chain at n = 20, the one-thread template ``step_member``),
``generated40`` (``csrc/user_family_step.cu``'s float64 constant-table part
around the header ``ops/fused_codegen.py`` generates from the semiseparable
chain at n = 40) or ``semisep_wide`` (``csrc/semisep_wide.cu``'s float64
part); all three by default.  Each is compiled as the package builds it
(``kernels._flags``) and again with each variant's flags added:

- ``default``: nothing added;
- ``O2``, ``O1``: ``-Xptxas -O2`` / ``-O1`` (ptxas's optimization level);
- ``maxrreg255``: ``-maxrregcount=255``;
- ``noexpensive``: ``-Xptxas --allow-expensive-optimizations=false``.

Every compile runs at once, one nvcc each, into ``_build/ptxas_registers/``,
each stopped after ``--cap`` seconds.  Prints the card's name and power
limit, ``ptxas --version``, and per unit and variant the nvcc seconds and
each kernel instantiation's registers, stack frame and spills (and any
other line ptxas prints about it), then a last line of JSON.  The log also
goes to ``ptxas_registers.log`` in the repository's output directory.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
WORK = REPO / "hamilton_tpu_torch" / "_build" / "ptxas_registers"
_LOG = REPO / "chiprun_out" / "ptxas_registers.log"

VARIANTS = {
    "default": (),
    "O2": ("-Xptxas", "-O2"),
    "O1": ("-Xptxas", "-O1"),
    "maxrreg255": ("-maxrregcount=255",),
    "noexpensive": ("-Xptxas", "--allow-expensive-optimizations=false"),
}


def log(msg: str) -> None:
    print(msg, flush=True)
    with open(_LOG, "a") as f:
        f.write(msg + "\n")


def _units(names):
    """``{name: (source, flags, ptxas pattern, label)}``."""
    import chip_smoke as cs
    from hamilton_tpu_torch import kernels, models
    from hamilton_tpu_torch.ops import fused_codegen

    out = {}
    if "fused_step" in names:
        part = kernels.PARTS["fused_step"][1](1, 20, True)
        src, _, _ = kernels._paths("fused_step", part)
        out["fused_step"] = (src, kernels._flags("fused_step", part), cs._KERNEL_RE,
                             cs._k1_label)
    if "generated40" in names:
        system = models.chain(n_links=40, fused_solver="semiseparable", device="cpu",
                              dtype=__import__("torch").float64).system
        header = fused_codegen.generated(system.fused_forms(system)).header
        key, where, flags = kernels._user_family_paths(header)
        where.mkdir(parents=True, exist_ok=True)
        (where / "user_family.h").write_text(header)
        part = kernels.user_family_part(1, 0)
        out["generated40"] = (kernels.USER_FAMILY_TEMPLATE,
                              flags + ("-I", str(where), f"-DHAMILTON_PART={part}"),
                              cs._USER_RE, cs._user_label)
    if "semisep_wide" in names:
        src, _, _ = kernels._paths("semisep_wide", 1)
        out["semisep_wide"] = (src, kernels._flags("semisep_wide", 1), cs._WIDE_RE,
                               cs._wide_label)
    return out


def _compile(nvcc, src, flags, lib: Path, cap: float):
    """``(seconds or None at the cap, ptxas's report)``."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen([nvcc, *flags, "-o", str(lib), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=cap)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        return None, ""
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {stderr[-4000:]}")
    return time.perf_counter() - t0, stdout + stderr


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--cap", type=float, default=900.0)
    ap.add_argument("units", nargs="*", default=["fused_step", "generated40", "semisep_wide"])
    args = ap.parse_args(argv)
    _LOG.parent.mkdir(exist_ok=True)
    _LOG.write_text("")

    import chip_smoke as cs
    from hamilton_tpu_torch import kernels

    log(f"card: {cs.card_line()}")
    nvcc = kernels._nvcc()
    ptxas = Path(nvcc).with_name("ptxas")
    log(subprocess.run([str(ptxas), "--version"], capture_output=True, text=True).stdout.strip())
    units = _units(set(args.units))
    variants = args.variants.split(",")
    jobs = {(u, v): (units[u][0], units[u][1] + VARIANTS[v], WORK / f"lib{u}-{v}.so")
            for u in units for v in variants}
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {key: pool.submit(_compile, nvcc, src, flags, lib, args.cap)
                   for key, (src, flags, lib) in jobs.items()}
    out = {}
    for (u, v), fut in futures.items():
        seconds, text = fut.result()
        pattern, label = units[u][2], units[u][3]
        regs = cs.ptxas_report(text, pattern, label)
        frames = cs.ptxas_frames(text, pattern, label)
        others = sorted({line.strip() for line in text.splitlines()
                         if "ptxas" in line and not re.search(
                             r"Compiling entry|Function properties|Used \d+ registers|"
                             r"bytes stack frame|Compile time|bytes gmem|Compiling entry", line)})
        out[f"{u} {v}"] = {"seconds": seconds, "ptxas": regs, "frames": frames,
                           "other_lines": others[:20]}
        log(f"{u} {v}: " + (f"nvcc {seconds:.1f} s" if seconds is not None
                            else f"stopped at the {args.cap:.0f} s cap"))
        for kname, nreg, st, ld in regs:
            log(f"  {kname:<50} {nreg:3d} registers, stack frame "
                f"{frames.get(kname, (0,))[0]} B, spill stores {st} B, spill loads {ld} B")
        for line in others[:20]:
            log(f"  | {line}")
    log(json.dumps({"card": cs.card_line(), "units": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
