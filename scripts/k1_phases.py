#!/usr/bin/env python3
"""Where a K1 chain launch spends its cycles, by phase of the step, on one
card.

    python3 scripts/k1_phases.py [FORM ...]

FORM is ``semiseparable`` (default; ``csrc/fused_step.cu``) or ``mobius``
(``csrc/chain_variants.cu``), run as the sources ship them on the one-thread
template ``step_member`` (``csrc/fused_step.cuh``).  The script copies the
package to ``hamilton_tpu_torch/_build/k1_phases/``, wraps each of
``step_member``'s calls of the policy's ``aux``, ``aux_at``, ``factor``,
``solve`` and ``dhdq`` in the copy with ``clock64()`` reads (lane 0 of each
warp adds the cycles to a device counter) and the whole step likewise, builds
the form's float32 n = 20 part, and runs one 50-step launch of the headline
configuration (16384 members, Kahan (2,0), dt = 5e-4, shared table).  The
package itself is not touched.

Prints the card's name and power limit and, per form, the cycles a warp
spends a step in each phase, their shares of the step, and the probed
launch's device ms (the reads cost time: compare shares, not times, with an
unprobed kernel); a last line of JSON.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WORK = ROOT / "hamilton_tpu_torch" / "_build" / "k1_phases"
PHASES = ("aux", "aux_at", "factor", "solve", "dhdq")
BATCH, SPC = 16384, 50
SOURCES = {"semiseparable": ("fused_step", 20), "mobius": ("chain_variants", 0)}

PROBE = """
__device__ unsigned long long g_phase_cycles[8];
__device__ __forceinline__ long long phase_clock() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}
struct PhaseClock {
  int k;
  long long t0;
  __device__ explicit PhaseClock(int k_) : k(k_) { t0 = phase_clock(); }
  __device__ ~PhaseClock() {
    const long long t1 = phase_clock();
    if ((threadIdx.x & 31) == 0) atomicAdd(&g_phase_cycles[k], (unsigned long long)(t1 - t0));
  }
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


def _copy() -> Path:
    pkg = WORK / "hamilton_tpu_torch"
    if pkg.exists():
        shutil.rmtree(pkg)
    shutil.copytree(ROOT / "hamilton_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    header = pkg / "csrc" / "fused_step.cuh"
    text = header.read_text().replace("namespace {\n", "namespace {\n" + PROBE, 1)
    count = 0
    for k, phase in enumerate(PHASES):
        text, n = re.subn(rf"(P::{phase}\([^;]*\);)", rf"{{ PhaseClock clock_({k}); \1 }}", text)
        count += n
    text, n = re.subn(r"(  typename P::Aux ax;[^\n]*\n)", r"\1  PhaseClock step_clock_(5);\n", text)
    if count < 10 or n != 1:
        raise RuntimeError(f"{header}: {count} phase calls and {n} step clocks wrapped")
    header.write_text(text)
    for source, _ in SOURCES.values():
        src = pkg / "csrc" / f"{source}.cu"
        src.write_text(src.read_text() + ENTRIES)
    return WORK


def main(argv) -> int:
    forms = argv or ["semiseparable"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    where = _copy()
    sys.path[:0] = [str(where), str(ROOT)]
    import numpy as np
    import torch

    from hamilton_tpu_torch import kernels

    if not Path(kernels.__file__).is_relative_to(where):
        raise RuntimeError(f"imported {kernels.__file__}, not the copy in {where}")
    import hamilton_tpu_torch as tp
    from hamilton_tpu_torch.ops.fused_step import coef_table, fused_step_kernel, fused_stepper
    from hamilton_tpu_torch.utils.profiling import time_queued

    dev = torch.device("cuda")
    rows = {}
    for form in forms:
        source, code = SOURCES[form]
        part = kernels.PARTS[source][1](0, code)
        lib = ctypes.CDLL(str(kernels.build(source, parts=(part,)).paths[0]))
        ex = tp.chain(n_links=20, fused_solver=form, device=dev, dtype=torch.float32)
        forms_ = ex.system.fused_forms(ex.system)
        rng = np.random.default_rng(0)
        q = ex.init_phase.q.cpu().numpy() + 0.01 * rng.standard_normal((BATCH, 20))
        ph = tp.Phase(torch.tensor(q, dtype=torch.float32, device=dev),
                      ex.init_phase.p.to(torch.float32).expand(BATCH, 20).contiguous())
        state = fused_stepper(forms_, iters=(2, 0), compensated=True).init(ph)
        kw = dict(iters=(2, 0), compensated=True, steps_per_call=SPC,
                  coef=coef_table(forms_, dev, torch.float32))
        fused_step_kernel(forms_, state, 5e-4, **kw)
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * 8)()
        lib.hamilton_phase_cycles(out, 1)
        fused_step_kernel(forms_, state, 5e-4, **kw)
        torch.cuda.synchronize()
        if lib.hamilton_phase_cycles(out, 0) != 0:
            raise RuntimeError("reading the phase counters failed")
        warp_steps = BATCH // 32 * SPC
        cycles = {name: out[k] / warp_steps for k, name in enumerate(PHASES)}
        cycles["step"] = out[5] / warp_steps
        ms, _ = time_queued(lambda: fused_step_kernel(forms_, state, 5e-4, **kw), 20)
        rows[form] = {"cycles_per_warp_step": cycles, "probed_ms": ms}
        print(f"{form}: a warp's step {cycles['step']:.0f} cycles: " + ", ".join(
            f"{k} {v:.0f} ({v / cycles['step']:.3f})" for k, v in cycles.items() if k != "step")
            + f"; probed launch {ms:.4f} ms", flush=True)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
