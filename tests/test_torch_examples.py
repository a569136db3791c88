"""The port's hmc example (``hamilton_tpu_torch/examples/hmc.py``) against
the JAX package's, on the CPU; the chaos scan is in
``test_torch_chaos_scan.py``, the ensemble sweep in
``test_torch_ensemble_sweep.py``.

``hmc_iteration`` takes its momentum and uniform draws as tensors, so both
packages see the same draws (numpy, from a seed): one iteration on 32
chains in float64 gives the same positions to 1e-12 and the same
acceptances.  ``hmc.main`` at the reference test's size returns 0.  Without
a card and without ``--device cpu`` each of the three examples exits with a
message naming it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hamilton_tpu as ht
from hamilton_tpu.integrators import make_stepper as j_make_stepper
from hamilton_tpu.state import Phase as JPhase

from hamilton_tpu_torch.examples import chaos_scan, ensemble_sweep, hmc
from hamilton_tpu_torch.integrators.fixed import make_stepper

F64 = torch.float64
def _reference_gaussian():
    n = 3

    def coords(q, params):
        return q

    def potential(x, params):
        return 0.5 * jnp.einsum("...i,ij,...j->...", x, params["prec"].astype(x.dtype), x)

    return ht.mk_system_cart(jnp.ones(n), coords, potential, n=n, name="hmc-gaussian",
                             params={"prec": jnp.asarray(np.linalg.inv(hmc.COV))})


def test_hmc_iteration_matches_the_reference():
    """One iteration on 32 chains (L = 16, dt = 0.25, float64) from the same
    draws: the reference's stepper loop, ``hamiltonian`` and Metropolis
    test."""
    rng = np.random.default_rng(0)
    q, p0 = rng.standard_normal((32, 3)), rng.standard_normal((32, 3))
    u = rng.uniform(size=32)
    u[:4] = [0.0, 0.999999, 0.5, 1e-9]
    jsys = _reference_gaussian()
    jst = j_make_stepper(jsys, "leapfrog", iters=(1, 1))
    ph0 = JPhase(jnp.asarray(q), jnp.asarray(p0))
    h0 = ht.hamiltonian(jsys, ph0)
    sc = jax.lax.fori_loop(0, 16, lambda _, c: jst.step(c, 0.25), jst.init(ph0))
    ph1 = jst.extract(sc)
    dh = ht.hamiltonian(jsys, ph1) - h0
    jaccept = jnp.asarray(u) < jnp.exp(-dh)
    jq = jnp.where(jaccept[:, None], ph1.q, ph0.q)

    tsys = hmc.gaussian_system("cpu", F64)
    q1, accept = hmc.hmc_iteration(tsys, make_stepper(tsys, "leapfrog", iters=(1, 1)),
                                   torch.tensor(q), torch.tensor(p0), torch.tensor(u),
                                   torch.tensor(0.25, dtype=F64), 16)
    np.testing.assert_array_equal(accept.numpy(), np.asarray(jaccept))
    np.testing.assert_allclose(q1.numpy(), np.asarray(jq), rtol=0, atol=1e-12)
    assert 0 < int(accept.sum()) < 32


def test_hmc_main_returns_0():
    """``main`` at the reference test's size (32 chains, 200 iterations, 50
    warm-up) on the CPU: acceptance in band, covariance within 0.2."""
    assert hmc.main(["--chains", "32", "--iters", "200", "--warmup", "50",
                     "--device", "cpu"]) == 0


@pytest.mark.parametrize("module", [hmc, chaos_scan, ensemble_sweep],
                         ids=["hmc", "chaos_scan", "ensemble_sweep"])
def test_without_a_card_the_examples_ask_for_the_cpu(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        module.main([])
