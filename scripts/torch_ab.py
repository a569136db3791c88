#!/usr/bin/env python3
"""Time several versions of the PyTorch port on one card, in turns.

    python3 scripts/torch_ab.py [--rounds N | --build-only | --accuracy] [--only R,R,...]
                                TREE [TREE ...]

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
  forms, ``csrc/chain_variants.cu``), and ``linv5`` (the L⁻¹ form at n = 5,
  ``chip_smoke.py`` phase 16 (e)'s row: (2,0), Kahan, dt=5e-4).
  Each is the device ms of one launch, from CUDA events around 100 launches
  queued behind a held stream (``utils.profiling.time_queued`` of this
  checkout, for every tree);
- the dense chain's K1 on one thread a member at its callers' shapes:
  ``chaos_scan`` (``chip_smoke.py`` phase 20 (a): ``csrc/fused_step.cu``'s
  dense n=2, 16384 pair members, per-member tables, (3,1), dt=5e-3, 40
  steps a launch) and ``fit_masses`` (phase 17 (d): ``csrc/
  chain_variants.cu``'s dense n=4, 1024 members, (3,1), dt=1e-2, 24 steps a
  launch), float32 without Kahan, device ms as above;
- the families' K1 (``csrc/family_step.cu``) on ``chip_smoke.py`` phase 15
  (e)'s rows (``family_<name>``: f32 Kahan (2,0), 50 steps a launch, each
  family's dt, the shared table, the same inputs), and the generated K1
  (``csrc/user_family_step.cu``) on phase 18's: ``generated_bezier3`` (e)
  and ``generated_elastic`` (f), the example's sweep (per-member tables,
  (2,1), one step a launch), device ms as above;
- the sine probe K3b (``csrc/roofline_probes.cu``): ``k3b``, the device
  ms of one call at ``PERF.md``'s row (1M float32 elements, 1024 reps, 4
  chains a thread, blocks of 256), timed as the K1 readings;
- the host's ms to issue one such launch through ``Stepper.step``
  (``headline_host``, ``double_pendulum_host``: the wall time of queuing
  those 100), and ``double_pendulum_wall``, the wall ms per launch of 400
  chained launches up to a synchronize (the double pendulum's kernel is
  shorter than its issue);
- two host-bound library paths on chain-20, wall ms up to a synchronize:
  ``library_leapfrog_step`` (float32, (2,0), Kahan, dt=5e-4, per step over
  20 steps) and ``adaptive_f64`` (``evolve_ham`` in float64 over
  t ∈ [0, 0.05], the whole call);
- the batched solves (K2, ``csrc/batched_spd.cu``) at 16384 × n=20 through
  the tree's entries: ``cholesky`` (K2b) and ``cho_solve`` (K2c) in float32
  and float64, ``spd_solve`` (K2a) and ``spd_solve_jac`` (K2d, m=40) in
  float64, ``cholesky_jac`` (K2e, m=40) in float32, and
  ``spd_solve_jac_n3`` (K2d at n = m = 3, spring's) in float64, each the
  device ms of one call from ``time_queued`` around 100 calls on one operand
  set, and (``_rotating``) on four sets in turn (at n = 20 more than the
  50 MB L2 holds).

Each tree's ``-Xptxas -v`` report of the K1 kernels (``csrc/fused_step.cu``,
``csrc/chain_variants.cu``, ``csrc/family_step.cu`` and the generated
kernels of phase 18, ``user_family_step: <family>``: registers and spill
bytes per instantiation, named by ``chip_smoke.py``'s parsers) and of the K2
kernels (``csrc/batched_spd.cu``, named by their mangled template names) is
held against the first tree's, instantiation by instantiation;
``--build-only`` stops there.
``--only`` times only the readings named (the others print as n/a), and
where each of them is a K1 reading of the dense chain on one thread
(``double_pendulum``, its ``_host`` and ``_wall``, ``chaos_scan``,
``fit_masses``), of the L⁻¹ form (``linv``, ``linv5``) or ``k3b``, builds
only the parts of ``fused_step.cu`` and ``chain_variants.cu`` that hold
them (and ``roofline_probes.cu``), and compares their reports.
``--accuracy`` then runs, for each tree in turn, ``chip_smoke.py``'s phase 1
semiseparable rows (chain-20 and chain-5, shared and per-member tables,
plain and ``suzuki4``, 1000, 1, 7 and 16383 members, float64 and float32,
50 steps) on that tree's K1 against that tree's plain version on the same
inputs, under this checkout's ``chip_smoke`` limits, and the tree's check of
its float functions (``kernels.libm_mismatches``) where it has one.

Prints the card's name and power limit, each tree's build seconds and its
ptxas comparison, a line per turn (per row with ``--accuracy``), and a last
line of JSON: ``{"card": ..., "trees": [...], "ms": {reading: [[turn ms,
...] per tree]}}``, or ``{"card": ..., "trees": [...], "accuracy": [{"rows":
[...], "libm": ...} per tree]}``.
"""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

BATCH, SPC, REPS = 16384, 50, 100
LEAPFROG_STEPS = 20
# the K2 readings: (entry, dtype, n); the J entries at m = 2n (n = 20) or
# m = n (n = 3, spring's); each also on K2_ROTATE operand sets in turn
K2_READINGS = (("cholesky", "float32", 20), ("cho_solve", "float32", 20),
               ("cholesky", "float64", 20), ("cho_solve", "float64", 20),
               ("spd_solve", "float64", 20), ("spd_solve_jac", "float64", 20),
               ("spd_solve_jac", "float64", 3), ("cholesky_jac", "float32", 20))
K2_ROTATE = 4
def _k2_reading(entry: str, dtype: str, n: int) -> str:
    return f"{entry}{'' if n == 20 else f'_n{n}'}_{dtype}"


# the families of chip_smoke.py phase 15, in its order (its generator is
# drawn across them in turn)
FAMILY_READINGS = ("spherical", "twobody", "spring", "room", "ellipse", "bezier", "bezier2")
READINGS = ("headline", "double_pendulum", "sweep", "suzuki4", "mobius", "linv", "linv5", "k3b",
            "headline_host",
            "double_pendulum_host", "double_pendulum_wall", "chaos_scan", "fit_masses",
            "library_leapfrog_step",
            "adaptive_f64") + tuple(f"family_{f}" for f in FAMILY_READINGS) + (
                "generated_bezier3", "generated_elastic") + tuple(
                    f"{_k2_reading(*k)}{r}" for k in K2_READINGS for r in ("", "_rotating"))
DP_WALL_LAUNCHES = 400
# the readings of one part of a source: reading → (source, its code; None:
# a source built whole), the part of each source that holds it (float32) is
# all --only builds for them
PART_UNITS = {"double_pendulum": ("fused_step", 2), "double_pendulum_host": ("fused_step", 2),
              "double_pendulum_wall": ("fused_step", 2), "chaos_scan": ("fused_step", 2),
              "fit_masses": ("chain_variants", 4), "linv": ("chain_variants", 2),
              "linv5": ("chain_variants", 3), "k3b": ("roofline_probes", None)}
# K3b's row: elements, reps, chains a thread, block
K3B_ROW = (64 * 16 * 1024, 1024, 4, 256)
# the K2 kernels as each tree's report names them (the mangled template name)
_K2_ANY_RE = re.compile(r"(?:solve_tile_kernel|jac_tile_kernel|factor_solve_kernel"
                        r"|factor_lanes_kernel|factor_kernel|substitute_lanes_kernel"
                        r"|substitute_kernel)I[fd](?:L[bi]\d+E)*")


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


def _chip_smoke():
    """This checkout's ``chip_smoke.py``, loaded from its file (a tree's
    root may hold its own)."""
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_ab_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _accuracy_tree(tree: str) -> dict:
    """Phase 1's semiseparable rows on this tree's K1 against its plain
    version (``chip_smoke.semisep_case``, ``compare_states`` under
    ``semisep_tol``), and its ``kernels.libm_mismatches()`` (None where the
    tree lacks it)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from hamilton_tpu_torch import kernels
    from hamilton_tpu_torch.ops.fused_step import (
        SUZUKI4_COMPOSITION, fused_step_kernel, fused_step_reference,
    )

    cs = _chip_smoke()
    dev = torch.device("cuda")
    rows = []
    for n in (20, 5):
        for batch in (1000,) + cs.RAGGED_BATCHES:
            for swept in (False, True):
                for comp in ((1.0,), SUZUKI4_COMPOSITION):
                    for dtype in (torch.float64, torch.float32):
                        forms, state, table = cs.semisep_case(dev, n, dtype, batch, swept,
                                                              comp, 3)
                        kw = dict(iters=(2, 0), compensated=True, composition=comp, coef=table,
                                  steps_per_call=50)
                        got = fused_step_kernel(forms, state, 5e-4, **kw)
                        want = fused_step_reference(forms, state, 5e-4, **kw)
                        dname = str(dtype).split(".")[-1]
                        _, errs, failures = cs.compare_states(got, want, dname,
                                                              cs.semisep_tol(n, dname))
                        rows.append({"n": n, "batch": batch, "per_member": swept,
                                     "suzuki4": len(comp) > 1, "dtype": dname,
                                     "errors": errs, "failures": failures})
    libm = kernels.libm_mismatches() if hasattr(kernels, "libm_mismatches") else None
    return {"rows": rows, "libm": libm}


def _wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _time_tree(tree: str, only=None) -> dict:
    """Each reading with this tree's package (None where the tree lacks it,
    or ``only`` does not name it)."""
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
    has["linv5"] = has["linv"]

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
    linv5 = tp.chain(n_links=5, fused_solver="linv", device=dev, dtype=f32)

    def want(*readings):
        return only is None or any(r in only for r in readings)

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
        "linv5": (lambda: linv5.system, linv5, "leapfrog_fused", (2, 0), True, 5e-4),
    }
    out = {}
    for name, (system_fn, ex, method, iters, comp, dt) in kernel_setups.items():
        if not has[name] or not want(name, f"{name}_host", f"{name}_wall"):
            out[name] = None  # not in this version, or not asked for
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

    if want("library_leapfrog_step"):
        lib = tp.make_stepper(chain.system, "leapfrog", iters=(2, 0), compensated=True)
        carry = lib.init(phase(chain))
        carry = lib.step(lib.step(carry, 5e-4), 5e-4)  # warm-up

        def leapfrog():
            c = carry
            for _ in range(LEAPFROG_STEPS):
                c = lib.step(c, 5e-4)

        out["library_leapfrog_step"] = _wall_ms(leapfrog) / LEAPFROG_STEPS
    if want("adaptive_f64"):
        ch64 = tp.chain(n_links=20, device=dev, dtype=f64)
        ph64 = phase(ch64, f64)
        tp.evolve_ham(ch64.system, ph64, [0.0, 0.01])  # warm-up
        out["adaptive_f64"] = _wall_ms(lambda: tp.evolve_ham(ch64.system, ph64, [0.0, 0.05]))
    if want("k3b"):
        from hamilton_tpu_torch.utils import roofline as rl

        elements, reps, chains, block = K3B_ROW
        x = torch.rand(elements, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(12))

        def k3b():
            return rl.sin_chain(x, reps, chains=chains, block=block)

        k3b()  # warm-up
        out["k3b"], _ = time_queued(k3b, REPS)
    with torch.no_grad():
        for name, launch in _dense_launches(dev, want).items():
            launch()  # warm-up
            out[name], _ = time_queued(launch, REPS)
    if want(*(r for r in READINGS if r.startswith(("family_", "generated_")))):
        out.update(_time_families(time_queued))
    if want(*(_k2_reading(*k) for k in K2_READINGS)):
        out.update(_time_k2(time_queued))
    return {r: v for r, v in out.items() if want(r)}


def _dense_launches(dev, want) -> dict:
    """``{reading: a launch}`` of the dense chain's one-thread K1 at
    ``chaos_scan``'s and ``fit_masses --fused``' shapes and inputs (those
    ``want`` asks for), through the tree's package."""
    import torch

    import hamilton_tpu_torch as tp
    from hamilton_tpu_torch.examples import chaos_scan
    from hamilton_tpu_torch.ops.fused_step import coef_table, fused_step_kernel, fused_stepper

    f32 = torch.float32
    out = {}
    if want("chaos_scan"):
        system, pairs, _, _ = chaos_scan.chaos_setup(64, 128, eps=1e-4, device=dev, dtype=f32)
        forms = system.fused_forms(system)
        state, table = fused_stepper(forms, iters=(3, 1), steps_per_call=40).init(pairs)
        out["chaos_scan"] = lambda: fused_step_kernel(
            forms, state, 5e-3, iters=(3, 1), compensated=False, steps_per_call=40, coef=table)
    if want("fit_masses"):
        ex4 = tp.chain(n_links=4, device=dev, dtype=f32)
        forms4 = ex4.system.fused_forms(ex4.system)
        ph4 = tp.Phase(ex4.init_phase.q.expand(1024, 4).contiguous(),
                       torch.tensor([0.8, -0.3, 0.5, -0.2], dtype=f32,
                                    device=dev).expand(1024, 4).contiguous())
        state4 = fused_stepper(forms4, iters=(3, 1)).init(ph4)
        coef4 = coef_table(forms4, dev, f32)
        out["fit_masses"] = lambda: fused_step_kernel(
            forms4, state4, 1e-2, iters=(3, 1), compensated=False, steps_per_call=24,
            coef=coef4)
    return out


def _family_launches(dev):
    """``{reading: a launch}`` of the families' and the generated K1 at
    ``chip_smoke.py`` phase 15 (e)'s and phase 18 (e)/(f)'s shapes and
    inputs, through the tree's package."""
    import numpy as np
    import torch

    import hamilton_tpu_torch as tp
    from hamilton_tpu_torch.examples import elastic_pendulum
    from hamilton_tpu_torch.ops.fused_step import coef_table, fused_step_kernel, fused_stepper

    cs = _chip_smoke()
    f32, f64 = torch.float32, torch.float64
    makes = {"spherical": (tp.spherical_pendulum, 0.05, 2.5e-4),
             "twobody": (tp.two_body, 0.02, 2.5e-4), "spring": (tp.spring, 0.02, 1e-3),
             "room": (tp.room, 0.05, 2.5e-4), "ellipse": (tp.ellipse, 0.05, 2.5e-4),
             "bezier": (tp.bezier, 0.05, 2.5e-4),
             "bezier2": (lambda **k: tp.bezier(cs.BEZIER2_POINTS, **k), 0.05, 2.5e-4)}
    kw = dict(iters=(2, 0), compensated=True, steps_per_call=cs.FAMILY_SPC)
    out = {}
    rng = np.random.default_rng(16)
    for name in FAMILY_READINGS:
        make, scale, dt = makes[name]
        system = make(device=dev, dtype=f32).system
        forms = system.fused_forms(system)
        state = fused_stepper(forms, **kw).init(
            cs.family_phase(make(device=dev, dtype=f64), BATCH, scale, rng, dev))
        coef = coef_table(forms, dev, f32)
        out[f"family_{name}"] = (lambda f=forms, s=state, d=dt, c=coef:
                                 fused_step_kernel(f, s, d, coef=c, **kw))
    bz = tp.bezier(cs.BEZIER3_POINTS, device=dev, dtype=f32).system
    forms = bz.fused_forms(bz)
    state = fused_stepper(forms, **kw).init(cs.family_phase(
        tp.bezier(cs.BEZIER3_POINTS, device=dev, dtype=f64), BATCH, 0.05,
        np.random.default_rng(11), dev))
    out["generated_bezier3"] = lambda: fused_step_kernel(forms, state, 2.5e-4, **kw)
    k_grid = torch.linspace(0.35 * 3.0 * 9.8, 2.0 * 3.0 * 9.8, BATCH, dtype=f32, device=dev)
    sweep = elastic_pendulum.make_system(device=dev, dtype=f32).replace_params({
        "mass": torch.ones(BATCH, dtype=f32, device=dev),
        "gravity": torch.full((BATCH,), 9.8, dtype=f32, device=dev),
        "spring_k": k_grid, "rest_length": torch.ones(BATCH, dtype=f32, device=dev)})
    el_forms = sweep.fused_forms(sweep)
    q0 = torch.stack([torch.full((BATCH,), 0.01, dtype=f32, device=dev),
                      1.0 + 9.8 / k_grid + 0.15], dim=-1)
    el_state, el_table = fused_stepper(el_forms, iters=(2, 1)).init(
        tp.Phase(q0, torch.zeros_like(q0)))
    out["generated_elastic"] = lambda: fused_step_kernel(
        el_forms, el_state, 5e-3, iters=(2, 1), compensated=False, steps_per_call=1,
        coef=el_table)
    return out


def _time_families(time_queued) -> dict:
    """The family and generated K1 readings (none where the tree lacks the
    generated kernel)."""
    import torch

    from hamilton_tpu_torch import kernels

    if not hasattr(kernels, "build_user_family"):
        return {}
    out = {}
    with torch.no_grad():
        for name, launch in _family_launches(torch.device("cuda")).items():
            launch()  # warm-up (a generated kernel's build, done by --build-tree)
            out[name], _ = time_queued(launch, REPS)
    return out


def _time_k2(time_queued) -> dict:
    """The K2 readings through the tree's entries (``ops.batched_spd``), on
    operands from this checkout's ``chip_smoke.k2_inputs``."""
    import torch

    from hamilton_tpu_torch.ops import batched_spd as bs

    cs = _chip_smoke()
    dev = torch.device("cuda")
    calls = {"cholesky": lambda k, js, b, low: bs.cholesky_batched(k),
             "cho_solve": lambda k, js, b, low: bs.cho_solve_batched(low, b),
             "spd_solve": lambda k, js, b, low: bs.spd_solve_batched(k, b),
             "spd_solve_jac": lambda k, js, b, low: bs.spd_solve_jac(js, b),
             "cholesky_jac": lambda k, js, b, low: bs.cholesky_jac(js)}
    out, inputs = {}, {}
    with torch.no_grad():
        for entry, dname, n in K2_READINGS:
            if (n, dname) not in inputs:
                inputs[(n, dname)] = []
                for s in range(K2_ROTATE):
                    k, js, b = cs.k2_inputs(BATCH, n, getattr(torch, dname), dev, 7 + s,
                                            m=2 * n if n == 20 else n)
                    inputs[(n, dname)].append((k, js, b, bs.cholesky_plain(k)))
            sets = inputs[(n, dname)]
            call = calls[entry]
            call(*sets[0])  # warm-up
            name = _k2_reading(entry, dname, n)
            out[name], _ = time_queued(lambda: call(*sets[0]), REPS)
            turn = iter(range(10**9))
            out[f"{name}_rotating"], _ = time_queued(
                lambda: call(*sets[next(turn) % K2_ROTATE]), REPS)
    return out


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _ptxas_rows(logs: dict) -> dict:
    """``{instantiation: (registers, spill stores, spill loads)}`` of the K1
    and K2 kernels in nvcc's ``-Xptxas -v`` reports by source (K1's parsed
    as ``chip_smoke.py`` prints them, K2's by mangled name; a generated
    kernel's under ``user_family_step: <family>``)."""
    cs = _chip_smoke()
    patterns = {"fused_step": (cs._KERNEL_RE, cs._k1_label),
                "chain_variants": (cs._VARIANT_RE, cs._variant_label),
                "family_step": (cs._FAMILY_RE, cs._family_label),
                "batched_spd": (_K2_ANY_RE, lambda m: m.group(0))}
    return {f"{src}: {name}": (regs, st, ld) for src, log in logs.items()
            for name, regs, st, ld in cs.ptxas_report(
                log, *patterns.get(src, (cs._USER_RE, cs._user_label)))}


def _build_tree(tree: str, only=None) -> list:
    """Build the tree's kernels (every source at once, then the generated
    kernels of phase 18; or, where ``only`` names readings of
    :data:`PART_UNITS` alone, the parts that hold them):
    ``[seconds, {source: nvcc report}]`` (the K1 and K2 sources')."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    from hamilton_tpu_torch import kernels

    t = time.perf_counter()
    if only is not None and set(only) <= set(PART_UNITS):
        parts = {}
        for reading in only:
            source, code = PART_UNITS[reading]
            parts.setdefault(source, set())
            if code is not None:
                parts[source].add(kernels.PARTS[source][1](0, code, False))
        logs = {source: kernels.build(source, parts=tuple(sorted(p)) or None).log
                for source, p in parts.items()}
        return [time.perf_counter() - t, {k: v for k, v in logs.items()
                                          if k != "roofline_probes"}]
    built = kernels.build_all()
    logs = {k: built[k].log for k in ("fused_step", "chain_variants", "family_step",
                                      "batched_spd")}
    if hasattr(kernels, "build_user_family"):
        for label, header in _chip_smoke().user_family_headers(torch.device("cpu")).items():
            logs[f"user_family_step: {label}"] = kernels.build_user_family(header)[1].log
    return [time.perf_counter() - t, logs]


def main(argv) -> int:
    only_args = []
    if len(argv) >= 2 and argv[0] == "--only":
        only_args, argv = argv[:2], argv[2:]
    only = only_args[1].split(",") if only_args else None
    if len(argv) >= 2 and argv[0] == "--time":
        print(json.dumps(_time_tree(argv[1], only)), flush=True)
        return 0
    if len(argv) >= 2 and argv[0] == "--build-tree":
        print(json.dumps(_build_tree(argv[1], only)), flush=True)
        return 0
    if len(argv) >= 2 and argv[0] == "--accuracy-tree":
        print(json.dumps(_accuracy_tree(argv[1])), flush=True)
        return 0
    rounds, build_only, accuracy = 1, False, False
    if len(argv) >= 2 and argv[0] == "--rounds":
        rounds, argv = int(argv[1]), argv[2:]
    elif argv and argv[0] in ("--build-only", "--accuracy"):
        build_only, accuracy, argv = argv[0] == "--build-only", argv[0] == "--accuracy", argv[1:]
    if len(argv) >= 2 and argv[0] == "--only":
        only_args, argv = argv[:2], argv[2:]
        only = only_args[1].split(",")
    trees = argv
    if not trees or rounds < 1 or (only is not None and not set(only) <= set(READINGS)):
        print(__doc__, file=sys.stderr)
        return 2
    card = _card()
    print(card, flush=True)
    procs = [subprocess.Popen([sys.executable, __file__, *only_args, "--build-tree", t],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for t in trees]
    first = None
    for tree, proc in zip(trees, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building {tree} failed:\n{err}")
        seconds, logs = json.loads(out.strip().splitlines()[-1])
        rows = _ptxas_rows(logs)
        print(f"build {tree}: {seconds:.1f} s, {len(rows)} K1 and K2 instantiations", flush=True)
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
    if accuracy:
        results = []
        for tree in trees:
            res = subprocess.run([sys.executable, __file__, "--accuracy-tree", tree],
                                 capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                raise RuntimeError(f"phase 1 rows of {tree} failed:\n{res.stderr}")
            results.append(json.loads(res.stdout.strip().splitlines()[-1]))
            for row in results[-1]["rows"]:
                print(f"{tree}: chain-{row['n']} {row['dtype']} B={row['batch']}"
                      f"{' per-member' if row['per_member'] else ''}"
                      f"{' suzuki4' if row['suzuki4'] else ''}: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in row["errors"].items())
                      + (f"; outside the limits: {'; '.join(row['failures'])}"
                         if row["failures"] else ""), flush=True)
            print(f"{tree}: float functions differing from sinf/cosf, sqrtf, 1/x: "
                  f"{results[-1]['libm']}", flush=True)
        print(json.dumps({"card": card, "trees": trees, "accuracy": results}))
        return 0
    ms = {r: [[] for _ in trees] for r in READINGS}
    order = (list(range(len(trees))) + list(reversed(range(len(trees))))) * rounds
    for i in order:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, __file__, *only_args, "--time", trees[i]],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"timing {trees[i]} failed:\n{res.stderr}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        for r in READINGS:
            ms[r][i].append(row.get(r))  # None: not in this tree
        print(f"turn {trees[i]} ({time.perf_counter() - t0:.1f} s): "
              + ", ".join(f"{r} {'n/a' if v is None else f'{v:.5f} ms'}"
                          for r, v in row.items()), flush=True)
    print(json.dumps({"card": card, "trees": trees, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
