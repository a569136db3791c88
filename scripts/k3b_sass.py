#!/usr/bin/env python3
"""The instructions of the sine probe K3b's loop, by kind, on one card.

    python3 scripts/k3b_sass.py [--tree DIR]

Builds DIR's (default: this checkout's) ``csrc/roofline_probes.cu`` through
its package, writes ``cuobjdump -sass`` of each ``sin_probe_kernel<CHAINS>``
to ``chiprun_out/k3b_sass.txt`` and counts, in its rep loop (the widest
conditional backward branch and its target), the instructions a rep runs
when every chain is in ``sincos_fast_range``: the loop less the code a
forward branch skips (the library's ``sinf``, taken for a chain outside the
range).  It checks that a sine's float32 FMAs, multiplies and adds and its
conversions there are ``utils.roofline.SIN_WORK``'s, the work K3b's bound
counts, and lists the rest by opcode (selects, logic, compares, constant
moves as ``IMAD``, the loop's own), which the bound leaves out.  Prints the
card's name and power limit, a line per instantiation and a last line of
JSON: ``{"card": ..., "chains": {CHAINS: {"per_sine": {kind: n},
"whole_loop": n, "opcodes": {op: n}}}}``.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# opcode (before its first '.') → the kinds of utils.roofline.SIN_WORK
KINDS = {"fp32": ("FFMA", "FMUL", "FADD"), "conversion": ("F2I", "I2F", "I2FP", "F2F")}


def _kind(op: str) -> str:
    return next((kind for kind, ops in KINDS.items() if op in ops), "other")


def _ops(block: str) -> list:
    """``[(address, opcode, operands, predicated)]`` of one function's SASS
    (the opcode without its modifiers)."""
    return [(int(a, 16), op, rest, bool(pred)) for a, pred, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)\S*([^\n]*)", block)]


def _target(rest: str):
    m = re.search(r"0x([0-9a-f]+)", rest.split(";")[0])
    return int(m.group(1), 16) if m else None


def _fast_loop(ops):
    """The rep loop's instructions that run when no chain leaves the range:
    the widest conditional backward branch's span (a block placed after the
    loop may jump back into it unconditionally), less each span a forward
    branch in it skips (the library's slow path), and the loop's whole
    span."""
    back = [(t, a) for a, op, rest, pred in ops if op == "BRA" and pred
            for t in [_target(rest)] if t is not None and t < a]
    lo, hi = max(back, key=lambda span: span[1] - span[0])
    loop = [o for o in ops if lo <= o[0] <= hi]
    skipped = [(a, t) for a, op, rest, _ in loop if op == "BRA"
               for t in [_target(rest)] if t is not None and a < t <= hi]
    fast = [o for o in loop if not any(a < o[0] < t for a, t in skipped)]
    return fast, loop


def main(argv) -> int:
    tree = ROOT
    if len(argv) >= 2 and argv[0] == "--tree":
        tree, argv = Path(argv[1]), argv[2:]
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from hamilton_tpu_torch import kernels; "
             "print(kernels.build('roofline_probes').paths[0])")
    lib = subprocess.run([sys.executable, "-c", build, str(tree.resolve())], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1]
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    blocks = [b for b in re.split(r"\n\s*Function : ", sass) if "sin_probe_kernel" in
              b.split("\n", 1)[0]]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "k3b_sass.txt").write_text("\n".join(f"Function : {b}" for b in blocks))
    sys.path.insert(0, str(ROOT))
    from hamilton_tpu_torch.utils.roofline import SIN_WORK
    want = {kind: count for kind, (count, _) in SIN_WORK.items()}
    result = {}
    for block in blocks:
        chains = int(re.search(r"sin_probe_kernelILi(\d+)E", block.split("\n", 1)[0]).group(1))
        fast, loop = _fast_loop(_ops(block))
        opcodes = Counter(o[1] for o in fast)
        kinds = Counter(_kind(o[1]) for o in fast)
        per_sine = {kind: n / chains for kind, n in kinds.items()}
        if {kind: per_sine.get(kind) for kind in want} != want:
            raise RuntimeError(f"sin_probe_kernel<{chains}>: a sine's work in the fast loop is "
                               f"{per_sine}, not SIN_WORK's {want}")
        result[chains] = {"per_sine": per_sine, "whole_loop": len(loop),
                          "opcodes": dict(opcodes)}
        print(f"sin_probe_kernel<{chains}>: fast loop {len(fast)} of {len(loop)} instructions; "
              + ", ".join(f"{k} {n / chains:.3f} a sine" for k, n in sorted(kinds.items()))
              + "; " + ", ".join(f"{op} {n}" for op, n in sorted(opcodes.items())), flush=True)
    print(json.dumps({"card": card, "chains": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
