#!/usr/bin/env python3
"""``chip_smoke.py`` phase 1's semiseparable rows two ways, in one call.

    python3 scripts/phase1_ab.py

Builds the semiseparable parts of ``csrc/fused_step.cu`` (chain-20 and
chain-5, both dtypes), then runs phase 1's semiseparable cases (chain-20
and chain-5, shared and per-member tables, plain and ``suzuki4``, on 1000,
1, 7 and 16383 members, float64 and float32, one 50-step launch each)
twice on the same inputs: first with one plain run per case (as phase 1
ran before), then as ``chip_smoke.phase1_semiseparable`` runs them (one
plain run on the members of every batch of a case put together, each
kernel run held against its slice).  Prints the card's name and power
limit, each way's seconds and failures, and a last line of JSON:
``{"card": ..., "per_batch_s": x, "grouped_s": y, "failures": [...]}``.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> int:
    import torch

    import chip_smoke as cs
    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.ops.fused_step import (
        SUZUKI4_COMPOSITION, fused_step_kernel, fused_step_reference,
    )

    if not torch.cuda.is_available():
        raise SystemExit("phase1_ab: needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    part = kernels.PARTS["fused_step"][1]
    kernels.build("fused_step", parts=tuple(part(d, n, True) for n in (20, 5) for d in (0, 1)))
    # chip_smoke.main's semisep_cases
    cases = [(n, swept, comp, batch) for n in (20, 5)
             for batch in (1000,) + cs.RAGGED_BATCHES
             for swept in (False, True) for comp in ((1.0,), SUZUKI4_COMPOSITION)
             if (n, swept, comp, batch) != (20, False, (1.0,), 1000)]

    failures = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n, swept, composition, batch in cases:
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[-1]
            forms, state, table = cs.semisep_case(dev, n, dtype, batch, swept, composition, 3)
            kw = dict(iters=(2, 0), compensated=True, composition=composition, coef=table,
                      steps_per_call=50)
            k_out = fused_step_kernel(forms, state, 5e-4, **kw)
            p_out = fused_step_reference(forms, state, 5e-4, **kw)
            torch.cuda.synchronize()
            _, _, bad = cs.compare_states(k_out, p_out, dname, cs.semisep_tol(n, dname))
            failures += [f"per batch n={n} B={batch} {dname}: {f}" for f in bad]
    per_batch = time.perf_counter() - t0
    print(f"per batch: {len(cases) * 2} plain runs, {per_batch:.1f} s", flush=True)
    t0 = time.perf_counter()
    failures += cs.phase1_semiseparable(dev, cases)
    grouped = time.perf_counter() - t0
    print(f"grouped: {grouped:.1f} s", flush=True)
    print(json.dumps({"card": card, "per_batch_s": per_batch, "grouped_s": grouped,
                      "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
