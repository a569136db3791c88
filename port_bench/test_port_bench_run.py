"""The harness's control flow at a size the CPU can run: one cell of each
configuration comes out correct; the same run with the timed path broken
underneath, and the lower-precision control in the program's place, come
out not correct; nothing the harness loads is JAX or the JAX package; a
checkout without the program prints no result."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from port_bench.control import control_numbers
from port_bench.program import ProgramSUT
from port_bench.run import run_cell
from port_bench.spec import ROOT
from port_bench.tiny import tiny_cell

SEED = 2**31 + 17  # wider than 32 signed bits, as the driver's are


def _run(cell, seed=SEED, trace=False):
    return run_cell(cell, seed=seed, seconds=0.2, trace=trace, device="cpu",
                    sut=ProgramSUT(cell, "cpu"), t_start=time.perf_counter())


@pytest.mark.parametrize("cell_name", ["chain20.ensemble", "double_pendulum.map"])
def test_one_job_per_configuration_is_correct(cell_name):
    result = _run(tiny_cell(cell_name))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0
    part = cell_name.split(".")[1]
    assert set(result["metrics"]) == {f"member_steps_per_s.{part}", "setup_s"}
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def test_only_the_checked_jobs_stop_at_chunk_ends(monkeypatch):
    from hamilton_tpu_torch import ensemble

    real, callbacks = ensemble.evolve_ensemble_chunked, []

    def spy(*args, **kw):
        callbacks.append(kw.get("carry_callback") is not None)
        return real(*args, **kw)

    monkeypatch.setattr(ensemble, "evolve_ensemble_chunked", spy)
    cell = tiny_cell("double_pendulum.map", steps=100, chunk=50)
    result = run_cell(cell, seed=SEED, seconds=0.5, trace=True, device="cpu",
                      sut=ProgramSUT(cell, "cpu"), t_start=time.perf_counter())
    assert result["correct"], result["checks"]
    window = callbacks[1:1 + result["run"]["jobs"]]  # the warm-up job comes first
    assert window[0] and sum(window) == len(result["run"]["checked_jobs"]) <= 2
    assert len(window) > 2
    assert not any(callbacks[1 + result["run"]["jobs"]:])  # the traced jobs


def test_traced_run_reports_per_layer_metrics_only():
    result = _run(tiny_cell("double_pendulum.map"), trace=True)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) <= {"k1_roofline_pct.map", "step_mfu.map",
                                      "device_idle_pct.map"}
    assert result["run"]["traced_jobs"] >= 1
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs_other_seed_other_inputs():
    from port_bench.traffic import initial_state

    cell = tiny_cell("double_pendulum.map")
    a = initial_state(cell.config, cell.traffic, SEED, 3, "cpu", torch.float32)[0]
    b = initial_state(cell.config, cell.traffic, SEED, 3, "cpu", torch.float32)[0]
    c = initial_state(cell.config, cell.traffic, SEED + 1, 3, "cpu", torch.float32)[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    lo, hi = cell.traffic["span"]
    assert float(a.min()) >= lo and float(a.max()) <= hi


def _unchanged(real):
    return lambda forms, state, dt, **kw: state.clone()


def _half_left_out(real):
    def step(forms, state, dt, **kw):
        out = real(forms, state, dt, **kw).clone()
        half = state.shape[-1] // 2
        out[..., half:] = state[..., half:]
        return out
    return step


def _answer_altered(real):
    # member 0's momentum reversed as each launch writes it: its energy is
    # kept, so only the reference following the chunk can see it
    def step(forms, state, dt, **kw):
        out = real(forms, state, dt, **kw).clone()
        out[1, :, 0] = -out[1, :, 0]
        return out
    return step


@pytest.mark.parametrize("cell_name", ["double_pendulum.map", "chain20.ensemble"])
@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _answer_altered])
def test_a_fault_in_the_timed_path_comes_out_not_correct(monkeypatch, cell_name, fault):
    from hamilton_tpu_torch.ops import fused_step as fs

    cell = tiny_cell(cell_name, steps=200, chunk=100) if "chain" in cell_name else \
        tiny_cell(cell_name)
    monkeypatch.setattr(fs, "fused_step", fault(fs.fused_step))
    result = _run(cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [None, _unchanged])
def test_a_sample_of_the_members_is_followed_on_large_cells(monkeypatch, fault):
    from hamilton_tpu_torch.ops import fused_step as fs
    from port_bench import check

    monkeypatch.setattr(check, "FOLLOW_MEMBERS", 4)
    if fault is not None:
        monkeypatch.setattr(fs, "fused_step", fault(fs.fused_step))
    result = _run(tiny_cell("double_pendulum.map"))
    assert result["correct"] == (fault is None), result["checks"]


@pytest.mark.parametrize("cell_name", ["chain20.ensemble", "double_pendulum.map"])
def test_the_lower_precision_control_comes_out_not_correct(cell_name):
    row = control_numbers(tiny_cell(cell_name, steps=200, chunk=100, drift_every=50), SEED,
                          "cpu")
    assert not row["correct"], row


def test_nothing_loaded_is_jax_or_the_jax_package():
    code = (
        "import sys, time, json\n"
        "from port_bench.run import run_cell, forbidden_loaded\n"
        "from port_bench.program import ProgramSUT\n"
        "from port_bench.tiny import tiny_cell\n"
        "cell = tiny_cell('double_pendulum.map', steps=100, chunk=50)\n"
        "run_cell(cell, seed=3, seconds=0.1, trace=False, device='cpu',\n"
        "         sut=ProgramSUT(cell, 'cpu'), t_start=time.perf_counter())\n"
        "import port_bench.control\n"
        "print(json.dumps({'forbidden': forbidden_loaded(),\n"
        "                  'program': 'hamilton_tpu_torch' in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "program": True}


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys\n"
            "import port_bench.reference.serial_chain, port_bench.check\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('hamilton')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                          "double_pendulum.map", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from port_bench.run import main

    assert main(["--workload", "double_pendulum.map", "--seed", str(SEED),
                 "--seconds", "2", "--trace", "0"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
