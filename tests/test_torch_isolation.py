"""The PyTorch port never imports JAX.

A fresh interpreter imports ``hamilton_tpu_torch``, builds a chain system,
takes a fused step, runs ``evolve_ham``, counts the fused step's operations,
takes a fused step of three model families and of the chain's Möbius and
L⁻¹ forms, differentiates through ``evolve_ham_fixed`` (the fused step's
replay and the K2 entries' backwards), runs one iteration of the
``fit_masses`` example, generates the elastic pendulum's kernel code, runs
that example's ``main`` at a tiny size, streams a transforming
observable through an ensemble driver, imports the CLI, the renderer, the
Poincaré, diagnostics and checkpoint utilities and the hmc, chaos-scan and
ensemble-sweep examples, runs the chaos scan's ``main`` at a tiny size,
imports ``hamilton_tpu_torch.parallel`` and runs a 2-shard CPU
``evolve_ensemble_sharded``, and runs the native engine's closed-form chain
once through the port's own binding (``hamilton_tpu_torch.native``);
``jax`` must stay out of ``sys.modules``.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

PROBE = """
import sys
import torch
import hamilton_tpu_torch as tp
ex = tp.chain(n_links=4, fused_solver="semiseparable", device="cpu", dtype=torch.float64)
st = tp.make_stepper(ex.system, "leapfrog_fused", iters=(2, 0), steps_per_call=2)
ph = tp.Phase(ex.init_config.q.expand(3, 4).contiguous(), torch.zeros(3, 4, dtype=torch.float64))
st.extract(st.step(st.init(ph), 1e-3))
tp.evolve_ham(ex.system, tp.Phase(ph.q, ph.p + 0.1), [0.0, 0.01])
from hamilton_tpu_torch.utils import profiling, roofline
roofline.fused_step_cost(ex.system, method="suzuki4_fused", iters=(2, 0))
for name in ("spherical", "room", "bezier"):
    fam = tp.get_example(name, device="cpu", dtype=torch.float64)
    fst = tp.make_stepper(fam.system, "leapfrog_fused", iters=(2, 0), steps_per_call=2)
    n = fam.n
    fph = tp.Phase(fam.init_config.q.expand(3, n).contiguous(), torch.zeros(3, n, dtype=torch.float64))
    fst.extract(fst.step(fst.init(fph), 1e-3))
for solver in ("mobius", "linv"):
    cx = tp.chain(n_links=4, fused_solver=solver, device="cpu", dtype=torch.float64)
    cst = tp.make_stepper(cx.system, "leapfrog_fused", iters=(2, 0))
    cst.extract(cst.step(cst.init(ph), 1e-3))
q = ph.q.clone().requires_grad_(True)
for method in ("leapfrog", "leapfrog_fused"):
    out = tp.evolve_ham_fixed(ex.system, tp.Phase(q, ph.p), 1e-3, 4, method=method,
                              iters=(2, 1), emit_every=2, remat=True)
    torch.autograd.grad(out.q.sum(), q)
from hamilton_tpu_torch.examples import fit_masses
fit_masses.main(["--device", "cpu", "--iters", "1", "--steps", "12"])
from hamilton_tpu_torch.examples import elastic_pendulum
from hamilton_tpu_torch.ops import fused_codegen
from hamilton_tpu_torch.utils import observables
esys = elastic_pendulum.make_system(device="cpu")
fused_codegen.generate(esys.fused_forms(esys))
elastic_pendulum.main(["--device", "cpu", "--fused", "--sweep", "8", "--steps", "100"])
pairs = observables.LyapunovPairs.pair_ensemble(tp.Phase(ph.q[:2], ph.p[:2]), 1e-6)
tp.evolve_ensemble_final(ex.system, pairs, 1e-3, 4, method="leapfrog", iters=(2, 1),
                         drift_every=2, observable=observables.LyapunovPairs(), obs_every=2)
import hamilton_tpu_torch.cli, hamilton_tpu_torch.render
from hamilton_tpu_torch.utils import checkpoint, diagnostics, poincare
from hamilton_tpu_torch.examples import chaos_scan, ensemble_sweep, hmc
chaos_scan.main(["--device", "cpu", "--fused", "--rows", "2", "--cols", "4", "--steps", "80"])
from hamilton_tpu_torch import parallel
ph4 = tp.Phase(ex.init_config.q.expand(4, 4).contiguous(), torch.zeros(4, 4, dtype=torch.float64))
tp.evolve_ensemble_sharded(ex.system, ph4, 1e-3, 4, mesh=parallel.ensemble_mesh(["cpu"] * 2),
                           method="leapfrog_fused", iters=(2, 0), drift_every=2)
import numpy as np
from hamilton_tpu_torch import native
assert native.available()
native.chain_evolve(np.ones(3), np.concatenate([np.full(3, 0.3), np.zeros(3)]), [0.0, 0.1])
print("jax" in sys.modules, any(m.startswith("hamilton_tpu.") or m == "hamilton_tpu"
                                for m in sys.modules))
"""


def test_port_leaves_jax_unimported():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].split() == ["False", "False"]


def test_port_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import|from) (jax|hamilton_tpu)\b", re.M)
    offenders = [
        str(path.relative_to(REPO))
        for path in sorted((REPO / "hamilton_tpu_torch").rglob("*.py"))
        if pattern.search(path.read_text())
    ]
    offenders += ["chip_smoke.py"] if pattern.search((REPO / "chip_smoke.py").read_text()) else []
    assert offenders == []
