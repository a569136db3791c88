#!/usr/bin/env python
"""The port's bfloat16 K2 entries against the reference's interpreted bf16
Pallas kernels at the sizes the test suite leaves out, on the CPU.

    python scripts/bf16_reference_check.py [--n 4 20] [--batch 1024]

For each n: ``spd_solve_pallas``, ``cholesky_pallas`` and
``cho_solve_pallas`` on bfloat16 operands under the Pallas interpreter (as
``tests/test_pallas.py::test_bf16_path`` runs them; at n = 20 XLA compiles
them for ~8 minutes) beside ``hamilton_tpu_torch.ops.batched_spd``'s bf16
entries on the same operands (random SPD K from a seed, as
``tests/test_torch_batched_spd.py`` makes them).  Prints, for each output,
the largest difference of each side from the float64 answer and of the two
sides from each other, relative to the output's largest value: the
readings behind ``BF16_REL`` in ``tests/test_torch_batched_spd.py``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[4, 20])
    ap.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch
    from jax.experimental.pallas import tpu as pltpu

    from hamilton_tpu.ops import pallas_solve as ps
    from hamilton_tpu_torch.ops import batched_spd as bs

    for n in args.n:
        rng = np.random.default_rng(n)
        a = rng.standard_normal((args.batch, n, n))
        k = (np.einsum("bij,bkj->bik", a, a) + n * np.eye(n)).astype(np.float32)
        vec = rng.standard_normal((args.batch, n)).astype(np.float32)
        t0 = time.perf_counter()
        with pltpu.force_tpu_interpret_mode():
            jk, jv = jnp.asarray(k, jnp.bfloat16), jnp.asarray(vec, jnp.bfloat16)
            ref = {"x": ps.spd_solve_pallas(jk, jv), "L": ps.cholesky_pallas(jk)}
            ref["cho-solve x"] = ps.cho_solve_pallas(ref["L"], jv)
        el = time.perf_counter() - t0
        tk, tv = torch.tensor(k).bfloat16(), torch.tensor(vec).bfloat16()
        tl = bs.cholesky_batched(tk)
        port = {"x": bs.spd_solve_batched(tk, tv), "L": tl,
                "cho-solve x": bs.cho_solve_batched(tl, tv)}
        x64 = np.linalg.solve(k.astype(np.float64), vec.astype(np.float64)[..., None])[..., 0]
        want = {"x": x64, "L": np.linalg.cholesky(k.astype(np.float64)), "cho-solve x": x64}
        for name, w in want.items():
            r = np.asarray(jnp.asarray(ref[name], jnp.float32), dtype=np.float64)
            p = port[name].float().numpy().astype(np.float64)
            scale = np.abs(w).max()
            print(f"n={n} B={args.batch} {name}: reference vs float64 "
                  f"{np.abs(r - w).max() / scale:.3e}, port vs float64 "
                  f"{np.abs(p - w).max() / scale:.3e}, port vs reference "
                  f"{np.abs(p - r).max() / scale:.3e} (relative to {scale:.4f}; the "
                  f"reference interpreted in {el:.1f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
