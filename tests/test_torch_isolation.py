"""The PyTorch port never imports JAX.

A fresh interpreter imports ``hamilton_tpu_torch``, builds a chain system,
takes a fused step, runs ``evolve_ham`` and counts the fused step's
operations; ``jax`` must stay out of ``sys.modules``.
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
print("jax" in sys.modules, any(m.startswith("hamilton_tpu.") or m == "hamilton_tpu"
                                for m in sys.modules))
"""


def test_port_leaves_jax_unimported():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


def test_port_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import|from) (jax|hamilton_tpu)\b", re.M)
    offenders = [
        str(path.relative_to(REPO))
        for path in sorted((REPO / "hamilton_tpu_torch").rglob("*.py"))
        if pattern.search(path.read_text())
    ]
    offenders += ["chip_smoke.py"] if pattern.search((REPO / "chip_smoke.py").read_text()) else []
    assert offenders == []
