#!/usr/bin/env python3
"""Time several versions of the PyTorch port on one card, in turns.

    python3 scripts/torch_ab.py [--rounds N | --build-only] TREE [TREE ...]

Each TREE is a directory holding a ``hamilton_tpu_torch/`` package: the root
of a checkout, or a parent commit unpacked with ``git archive`` into the
gitignored ``_archive/`` (``_archive/parent``).  The script builds every
tree's kernels at once (one process per tree), then times each tree in the
order T1..Tk, Tk..T1 (``N`` times over, default once), each turn in a
fresh interpreter that imports only that tree's package, so that versions
compare on one card under one power limit and on one host.

Readings, all on 16384 members:

- the fused-step kernel (K1), float32, 50 steps per launch: ``headline``
  (chain-20 semiseparable, (2,0), Kahan, dt=5e-4), ``double_pendulum``
  (dense n=2, (2,1), dt=1e-3), and where the tree has them (n/a otherwise)
  ``sweep`` (the headline with per-member masses and gravity) and
  ``suzuki4`` (the headline's kernel running ``suzuki4_fused``, dt=1e-3),
  ``mobius`` and ``linv`` (the headline on the chain's Möbius and L⁻¹
  forms, ``csrc/chain_variants.cu``).
  Each is the device ms of one launch, from CUDA events around 100 launches
  queued behind a held stream (``utils.profiling.time_queued`` of this
  checkout, for every tree);
- the host's ms to issue one such launch through ``Stepper.step``
  (``headline_host``, ``double_pendulum_host``: the wall time of queuing
  those 100), and ``double_pendulum_wall``, the wall ms per launch of 400
  chained launches up to a synchronize (the double pendulum's kernel is
  shorter than its issue);
- two host-bound library paths on chain-20, wall ms up to a synchronize:
  ``library_leapfrog_step`` (float32, (2,0), Kahan, dt=5e-4, per step over
  20 steps) and ``adaptive_f64`` (``evolve_ham`` in float64 over
  t ∈ [0, 0.05], the whole call).

Each tree's ``-Xptxas -v`` report of the K1 kernels (``csrc/fused_step.cu``,
``csrc/chain_variants.cu`` and ``csrc/family_step.cu``: registers and spill
bytes per instantiation) is held against the first tree's, instantiation by
instantiation; ``--build-only`` stops there.

Prints the card's name and power limit, each tree's build seconds and its
ptxas comparison, a line per turn, and a last line of JSON:
``{"card": ..., "trees": [...], "ms": {reading: [[turn ms, ...] per tree]}}``.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

BATCH, SPC, REPS = 16384, 50, 100
LEAPFROG_STEPS = 20
READINGS = ("headline", "double_pendulum", "sweep", "suzuki4", "mobius", "linv", "headline_host",
            "double_pendulum_host", "double_pendulum_wall", "library_leapfrog_step",
            "adaptive_f64")
DP_WALL_LAUNCHES = 400


def _time_queued():
    """The timing helper of this checkout's port (``utils/profiling.py``),
    loaded from its file so that every tree is timed by the same code, even
    a tree that lacks it."""
    path = Path(__file__).resolve().parent.parent / "hamilton_tpu_torch/utils/profiling.py"
    spec = importlib.util.spec_from_file_location("_ab_profiling", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclass resolves annotations there
    spec.loader.exec_module(mod)
    return mod.time_queued


def _wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _time_tree(tree: str) -> dict:
    """Each reading with this tree's package (None where the tree lacks it)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    import hamilton_tpu_torch as tp
    from hamilton_tpu_torch.convert import params_from_numpy
    from hamilton_tpu_torch.ops import fused_step
    from hamilton_tpu_torch.state import Phase

    time_queued = _time_queued()
    # the readings this tree has: per-member tables and the compositions
    # came with member_table and FUSED_COMPOSITIONS
    has = {"headline": True, "double_pendulum": True,
           "sweep": hasattr(fused_step, "member_table"),
           "suzuki4": "suzuki4_fused" in getattr(fused_step, "FUSED_COMPOSITIONS", ()),
           "mobius": hasattr(fused_step, "serial_chain_forms_mobius"),
           "linv": hasattr(fused_step, "serial_chain_forms_linv")}

    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64

    def phase(ex, dtype=f32):
        ph0 = ex.init_phase
        n = ph0.q.shape[-1]
        rng = np.random.default_rng(0)
        q = ph0.q.cpu().numpy().astype(np.float64) + 0.01 * rng.standard_normal((BATCH, n))
        p = ph0.p.cpu().to(dtype).expand(BATCH, n).contiguous()
        return Phase(torch.as_tensor(q, dtype=dtype).to(dev), p.to(dev))

    chain = tp.chain(n_links=20, fused_solver="semiseparable", device=dev, dtype=f32)
    forms_of = {s: (lambda s=s: tp.chain(n_links=20, fused_solver=s, device=dev, dtype=f32))
                for s in ("mobius", "linv")}
    dp = tp.double_pendulum(device=dev, dtype=f32)

    def swept():
        rng = np.random.default_rng(7)
        lengths = chain.system.params["lengths"].cpu().numpy()
        return chain.system.replace_params(params_from_numpy({
            "masses": 1.0 + 0.05 * rng.standard_normal((BATCH, 20)),
            "lengths": np.tile(lengths, (BATCH, 1)),
            "gravity": 5.0 + 0.1 * rng.standard_normal(BATCH),
        }, device=dev, dtype=f32))

    kernel_setups = {
        "headline": (lambda: chain.system, chain, "leapfrog_fused", (2, 0), True, 5e-4),
        "double_pendulum": (lambda: dp.system, dp, "leapfrog_fused", (2, 1), False, 1e-3),
        "sweep": (swept, chain, "leapfrog_fused", (2, 0), True, 5e-4),
        "suzuki4": (lambda: chain.system, chain, "suzuki4_fused", (2, 0), True, 1e-3),
        "mobius": (lambda: forms_of["mobius"]().system, chain, "leapfrog_fused", (2, 0), True,
                   5e-4),
        "linv": (lambda: forms_of["linv"]().system, chain, "leapfrog_fused", (2, 0), True,
                 5e-4),
    }
    out = {}
    for name, (system_fn, ex, method, iters, comp, dt) in kernel_setups.items():
        if not has[name]:
            out[name] = None  # not in this version
            continue
        st = tp.make_stepper(system_fn(), method, iters=iters, compensated=comp,
                             steps_per_call=SPC)
        carry = st.init(phase(ex))
        st.step(carry, dt)
        torch.cuda.synchronize()
        out[name], host = time_queued(lambda: st.step(carry, dt), REPS)
        if name in ("headline", "double_pendulum"):
            out[f"{name}_host"] = host
        if name == "double_pendulum":
            def run():
                c = carry
                for _ in range(DP_WALL_LAUNCHES):
                    c = st.step(c, dt)

            out["double_pendulum_wall"] = _wall_ms(run) / DP_WALL_LAUNCHES

    lib = tp.make_stepper(chain.system, "leapfrog", iters=(2, 0), compensated=True)
    carry = lib.init(phase(chain))
    carry = lib.step(lib.step(carry, 5e-4), 5e-4)  # warm-up

    def leapfrog():
        c = carry
        for _ in range(LEAPFROG_STEPS):
            c = lib.step(c, 5e-4)

    out["library_leapfrog_step"] = _wall_ms(leapfrog) / LEAPFROG_STEPS
    ch64 = tp.chain(n_links=20, device=dev, dtype=f64)
    ph64 = phase(ch64, f64)
    tp.evolve_ham(ch64.system, ph64, [0.0, 0.01])  # warm-up
    out["adaptive_f64"] = _wall_ms(lambda: tp.evolve_ham(ch64.system, ph64, [0.0, 0.05]))
    return out


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _ptxas_rows(logs: dict) -> dict:
    """``{instantiation: (registers, spill stores, spill loads)}`` of the K1
    kernels in nvcc's ``-Xptxas -v`` reports by source (parsed as
    ``chip_smoke.py`` prints them)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs

    patterns = {"fused_step": (cs._KERNEL_RE, cs._k1_label),
                "chain_variants": (cs._VARIANT_RE, cs._variant_label),
                "family_step": (cs._FAMILY_RE, cs._family_label)}
    return {f"{src}: {name}": (regs, st, ld) for src, log in logs.items()
            for name, regs, st, ld in cs.ptxas_report(log, *patterns[src])}


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--time":
        print(json.dumps(_time_tree(argv[1])), flush=True)
        return 0
    rounds, build_only = 1, False
    if len(argv) >= 2 and argv[0] == "--rounds":
        rounds, argv = int(argv[1]), argv[2:]
    elif argv and argv[0] == "--build-only":
        build_only, argv = True, argv[1:]
    trees = argv
    if not trees or rounds < 1:
        print(__doc__, file=sys.stderr)
        return 2
    card = _card()
    print(card, flush=True)
    build = ("import json, sys, time; sys.path.insert(0, sys.argv[1]); "
             "from hamilton_tpu_torch import kernels; t = time.perf_counter(); "
             "b = kernels.build_all(); "
             "print(json.dumps([time.perf_counter() - t, "
             "{k: b[k].log for k in ('fused_step', 'chain_variants', 'family_step')}]))")
    procs = [subprocess.Popen([sys.executable, "-c", build, str(Path(t).resolve())],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for t in trees]
    first = None
    for tree, proc in zip(trees, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building {tree} failed:\n{err}")
        seconds, logs = json.loads(out.strip().splitlines()[-1])
        rows = _ptxas_rows(logs)
        print(f"build {tree}: {seconds:.1f} s, {len(rows)} K1 instantiations", flush=True)
        if first is None:
            first = (tree, rows)
            continue
        differ = {k: (first[1].get(k), v) for k, v in rows.items() if first[1].get(k) != v}
        differ.update({k: (v, None) for k, v in first[1].items() if k not in rows})
        print(f"ptxas {tree} against {first[0]}: {len(rows) - len(differ)} of "
              f"{len(first[1])} instantiations equal in registers and spills"
              + "".join(f"\n  {k}: {a} -> {b}" for k, (a, b) in differ.items()), flush=True)
    if build_only:
        return 0
    ms = {r: [[] for _ in trees] for r in READINGS}
    order = (list(range(len(trees))) + list(reversed(range(len(trees))))) * rounds
    for i in order:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, __file__, "--time", trees[i]],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"timing {trees[i]} failed:\n{res.stderr}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        for r in READINGS:
            ms[r][i].append(row[r])
        print(f"turn {trees[i]} ({time.perf_counter() - t0:.1f} s): "
              + ", ".join(f"{r} {'n/a' if v is None else f'{v:.5f} ms'}"
                          for r, v in row.items()), flush=True)
    print(json.dumps({"card": card, "trees": trees, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
