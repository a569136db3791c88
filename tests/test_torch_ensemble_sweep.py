"""The port's ensemble sweep (``hamilton_tpu_torch/examples/ensemble_sweep.py``,
BASELINE configs[4]) against the JAX package's ``examples/ensemble_sweep.py``
on the CPU.

The reference runs in a subprocess, as ``tests/test_examples.py`` runs it,
so that it runs in float32 (it never enables x64; this suite's conftest
does, in-process).  ``--batch 16 --steps 200 --json``: the same fields, the
same configuration, the drift and the Lyapunov statistics to the stated
tolerances; then the fused path with the mass grid (per-member m₂).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from hamilton_tpu_torch.examples import ensemble_sweep

REPO = Path(__file__).resolve().parent.parent
ARGV = ["--batch", "16", "--steps", "200", "--json"]
# float32 twin trajectories 1e-4 apart over 200 steps: an ulp of the state
# is ~1e-3 of the separation, so the log-slope λ̂ differs between the two
# packages' float32 arithmetic by ~1e-3 (readings: mean 9.4e-4, max 2.6e-3);
# max|ΔH/H₀| is the same to a float32 ulp of H (reading: equal).
LAMBDA_TOL = 1e-2
DRIFT_TOL = 1e-6


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_sweep_fields_match_the_reference(capsys):
    # the process's own JAX settings (this suite's x64, its device count)
    # stay out: the reference runs as a user runs it, on the CPU
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "examples/ensemble_sweep.py", *ARGV, "--cpu"],
                          capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = _last_json(proc.stdout)
    assert ensemble_sweep.main(ARGV + ["--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert set(got) == set(want)
    for key in ("batch", "steps", "dt", "method", "chaotic_fraction"):
        assert got[key] == want[key], key
    # one device each: the reference runs on the one CPU device its
    # subprocess sees, the port on --device cpu (a mesh of one)
    assert got["devices"] == want["devices"] == 1
    assert abs(got["max_energy_drift"] - want["max_energy_drift"]) <= DRIFT_TOL
    for key in ("lyapunov_mean", "lyapunov_max"):
        assert abs(got[key] - want[key]) <= LAMBDA_TOL, (key, got[key], want[key])
    assert got["member_steps_per_sec"] > 0


def test_fused_sweep_with_a_mass_grid(capsys):
    """``--method leapfrog_fused --mass-grid 8``: per-member m₂ on the fused
    path (the plain K1 here), the grid and its chaotic fractions reported,
    the drift within the float32 leapfrog's."""
    assert ensemble_sweep.main(["--batch", "16", "--steps", "200", "--method",
                                "leapfrog_fused", "--mass-grid", "8", "--json",
                                "--device", "cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    assert got["method"] == "leapfrog_fused" and len(got["mass_grid_m2"]) == 8
    assert got["mass_grid_m2"][0] == 0.5 and got["mass_grid_m2"][-1] == 2.0
    assert len(got["chaotic_fraction_by_mass"]) == 8 and got["max_energy_drift"] < 1e-4
    with pytest.raises(SystemExit, match="divisible"):
        ensemble_sweep.main(["--batch", "12", "--mass-grid", "8", "--device", "cpu"])


def test_sharded_sweep_matches_one_device(capsys):
    """``--shards 4`` on the CPU: the members split over a mesh of four
    shards (``evolve_ensemble_sharded``) with the mass grid's per-member m₂
    split with them; every statistic equals the one-device run's."""
    argv = ["--batch", "16", "--steps", "100", "--method", "leapfrog_fused", "--mass-grid",
            "4", "--json", "--device", "cpu"]
    assert ensemble_sweep.main(argv) == 0
    one = _last_json(capsys.readouterr().out)
    assert ensemble_sweep.main(argv + ["--shards", "4"]) == 0
    four = _last_json(capsys.readouterr().out)
    assert one["devices"] == 1 and four["devices"] == 4
    for key in ("lyapunov_mean", "lyapunov_max", "chaotic_fraction", "max_energy_drift",
                "chaotic_fraction_by_mass"):
        assert four[key] == one[key], key
    with pytest.raises(SystemExit, match="divisible"):
        ensemble_sweep.main(["--batch", "18", "--shards", "4", "--device", "cpu"])
