"""The port's roofline accounting (``hamilton_tpu_torch/utils/roofline.py``)
against the JAX package's, and the probes' plain versions against numpy, on
the CPU.

The reference counts its fused kernel's operations by walking the jaxpr it
traces; the port counts them by running its own closed forms on counting
values.  Both count the same program, so the counts agree exactly: the
1 % allowance on flops is never used.  The probe kernels (K3a–K3c) run only
on the card (``tests/test_torch_kernel.py``); here their plain versions
meet independent numpy computations.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hamilton_tpu import models as jmodels
from hamilton_tpu.utils import roofline as j_roofline

import hamilton_tpu_torch as tp
from hamilton_tpu_torch.convert import params_from_numpy
from hamilton_tpu_torch.utils import profiling as t_profiling
from hamilton_tpu_torch.utils import roofline as t_roofline


def _costs_agree(j_cost, t_cost):
    """Transcendentals per member-step equal; flops within 1 %."""
    assert t_cost["transcendentals_per_member_step"] == \
        j_cost["transcendentals_per_member_step"]
    assert abs(t_cost["flops_per_member_step"] - j_cost["flops_per_member_step"]) \
        <= 0.01 * j_cost["flops_per_member_step"]
    assert t_cost["unknown_ops_per_member_step"] == 0.0
    assert t_cost["bytes_per_member_step"] == pytest.approx(
        j_cost["bytes_per_member_step"], rel=1e-12)
    assert (t_cost["n_sv"], t_cost["steps_per_call"]) == (j_cost["n_sv"], j_cost["steps_per_call"])


def test_op_sets_equal_the_reference():
    assert t_roofline._FLOP1 == j_roofline._FLOP1
    assert t_roofline._TRANS == j_roofline._TRANS


@pytest.mark.parametrize("method", ["leapfrog_fused", "suzuki4_fused"])
def test_fused_step_cost_matches_reference(method):
    """The headline's kernel, chain-20 semiseparable (2,0) Kahan, 50 steps
    per call, float32 (the case tests/test_pallas_step.py traces), and its
    Suzuki composition."""
    jex = jmodels.chain(n_links=20, fused_solver="semiseparable")
    jsys = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jex.system)
    j_cost = j_roofline.fused_step_cost(jsys, method=method, iters=(2, 0),
                                        steps_per_call=50)
    tex = tp.chain(n_links=20, fused_solver="semiseparable", device="cpu",
                   dtype=torch.float32)
    t_cost = t_roofline.fused_step_cost(tex.system, method=method, iters=(2, 0),
                                        steps_per_call=50)
    _costs_agree(j_cost, t_cost)
    if method == "leapfrog_fused":
        # one fresh aux evaluation a step in float32 (2n = 40 sin/cos) plus
        # the n square roots of the predictor factor, and the peeled step 0
        assert t_cost["transcendentals_per_member_step"] == pytest.approx(61.2)


@pytest.mark.parametrize("solver", ["mobius", "linv"])
def test_fused_step_cost_of_the_other_solvers_matches_reference(solver):
    """The Möbius and L⁻¹ forms at the headline's shape: the same counts as
    the reference's jaxpr walk, flops included (Möbius 3765.1 and L⁻¹
    7244.88 a member-step against the semiseparable form's 3729.4)."""
    jex = jmodels.chain(n_links=20, fused_solver=solver)
    jsys = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jex.system)
    j_cost = j_roofline.fused_step_cost(jsys, iters=(2, 0), steps_per_call=50)
    tex = tp.chain(n_links=20, fused_solver=solver, device="cpu", dtype=torch.float32)
    t_cost = t_roofline.fused_step_cost(tex.system, iters=(2, 0), steps_per_call=50)
    _costs_agree(j_cost, t_cost)
    assert t_cost["flops_per_member_step"] == j_cost["flops_per_member_step"]


@pytest.mark.parametrize("solver", ["semiseparable", "dense", "mobius", "linv"])
def test_fused_step_cost_of_a_sweep_matches_reference(solver):
    """Per-member tables (chain-4, B = 1024, (B, n) masses and lengths and
    (B,) gravity): the table entries are read, not folded, and the table
    adds its bytes once per call."""
    rng = np.random.default_rng(7)
    b = 1024
    params = {"masses": 1.0 + 0.05 * rng.standard_normal((b, 4)),
              "lengths": np.ones((b, 4)),
              "gravity": 5.0 + 0.1 * rng.standard_normal(b)}
    jsys = jmodels.chain(n_links=4, fused_solver=solver).system.replace_params(
        {k: jnp.asarray(v, jnp.float32) for k, v in params.items()})
    jsys = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jsys)
    j_cost = j_roofline.fused_step_cost(jsys, iters=(2, 0), steps_per_call=50)
    tsys = tp.chain(n_links=4, fused_solver=solver, device="cpu",
                    dtype=torch.float32).system
    tsys = tsys.replace_params(params_from_numpy(params, device="cpu", dtype=torch.float32))
    t_cost = t_roofline.fused_step_cost(tsys, iters=(2, 0), steps_per_call=50, batch=b)
    _costs_agree(j_cost, t_cost)
    shared = t_roofline.fused_step_cost(
        tp.chain(n_links=4, fused_solver=solver, device="cpu", dtype=torch.float32).system,
        iters=(2, 0), steps_per_call=50)
    assert t_cost["flops_per_member_step"] >= shared["flops_per_member_step"]
    with pytest.raises(ValueError, match="equal to the state batch"):
        t_roofline.fused_step_cost(tsys, iters=(2, 0), steps_per_call=50, batch=512)


def test_op_counter_folds_constants():
    c = t_roofline.OpCounter()
    x = c.value()
    y = 2.0 * 3.0 * x - (1.0 / 4.0)  # the constants fold: one mul, one sub
    z = c.fm.sqrt(-y) + c.fm.sin(0.5)  # neg, sqrt, add; sin(0.5) folds
    assert c.counts() == {"flops": 4, "transcendentals": 1, "unknown": 0}
    assert z.dtype == torch.float32


def test_fma_chain_plain_matches_numpy():
    """The plain version is the exact single-rounding FMA: numpy's float64
    product and sum of float32 operands are exact, rounded to float32 once
    a rep, so the two agree bit for bit; a mul-then-add in float32 rounds
    twice and drifts away from both."""
    rng = np.random.default_rng(0)
    x0 = (1.0 + rng.random(4096)).astype(np.float32)
    a = np.float64(np.float32(1.0000001))
    c = np.float64(np.float32(1.1920929e-07))
    want = x0.copy()
    for _ in range(200):
        want = (want.astype(np.float64) * a + c).astype(np.float32)
    got = t_roofline.fma_chain(torch.from_numpy(x0), 200)  # a CPU tensor: plain
    np.testing.assert_array_equal(got.numpy(), want)
    two = x0.copy()
    for _ in range(200):
        two = two * np.float32(a) + np.float32(c)
    assert not np.array_equal(two, want)


def test_sin_chain_plain_matches_numpy():
    """float32 sin against numpy's float32 sin: each is within an ulp or
    two of the true value and sin contracts the difference, so after 64
    reps the two agree within 1e-6 on values in (0, 1)."""
    x0 = np.linspace(0.1, 1.0, 1024, dtype=np.float32)
    want = x0.copy()
    for _ in range(64):
        want = np.sin(want) + np.float32(1.1920929e-07)
    got = t_roofline.sin_chain(torch.from_numpy(x0), 64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_add_one_plain_matches_numpy():
    a = np.arange(64, dtype=np.float32) - 7.5
    np.testing.assert_array_equal(t_roofline.add_one(torch.from_numpy(a)).numpy(), a + 1)


def test_probe_checks_and_bound():
    """The wrappers' checks need no card; the probes and benchmark_fn
    measure only a card, and fail without one."""
    with pytest.raises(ValueError, match="chains"):
        t_roofline._check_probe_input(torch.ones(48), 32, 128)
    with pytest.raises(ValueError, match="block"):
        t_roofline._check_probe_input(torch.ones(64), 16, 100)
    with pytest.raises(ValueError, match="float32"):
        t_roofline._check_probe_input(torch.ones(64, dtype=torch.float64), 16, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_roofline.vpu_peak_probe(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_profiling.benchmark_fn(lambda: None, device="cpu")
    ms, term = t_roofline.bound(67e9, 1e6)
    assert term == "operations" and ms == pytest.approx(1.0)
    ms, term = t_roofline.bound(1.0, 3.35e9, torch.float64)
    assert term == "bytes" and ms == pytest.approx(1.0)


def test_profile_trace_writes_a_trace(tmp_path):
    with t_profiling.profile_trace(None) as prof:
        assert prof is None
    with t_profiling.profile_trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert prof is not None and (tmp_path / "trace.json").is_file()
