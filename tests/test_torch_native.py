"""The port's binding to the native C++ engine (``hamilton_tpu_torch.native``)
against the JAX package's (``hamilton_tpu.native``), and the engine as the
port's oracle, on the CPU.

- Both bindings load the same source (``native/hamode.cpp``) built by the
  same Makefile, each into its own directory: for each function that evolves
  or steps, the same seeded inputs give the same numbers bit for bit.
- The GSL-semantics parity triangle of ``tests/test_native.py`` on the port:
  the port's float64 ``evolve_ham(method="rkf45")``, the engine driving the
  port's ``ham_rhs`` through its callback, and the engine's closed-form
  double pendulum agree pairwise within the reference's 1e-9.
- The port's AD chain against the engine's closed-form chain within 1e-8
  (n = 5; n = 3 with masses (2, 1, 0.5)).
- The gap that sets ``chip_smoke.ORACLE_CHAIN20_BOUND``: the JAX package's
  adaptive run of 8 members of ``chip_smoke.py`` phase 8's chain-20 batch
  against ``chain_evolve`` at eps 1e-13, and the port's within 10 times it.
- The OpenMP ensemble runner, the refusal of too few times, and where the
  library lands.
"""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hamilton_tpu as ht
from hamilton_tpu import native as j_native
from hamilton_tpu.models import chain as j_chain

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import native
from hamilton_tpu_torch.mechanics import ham_rhs

REPO = Path(__file__).resolve().parent.parent
F64 = torch.float64
TS = np.arange(0.0, 1.05, 0.1)
TRIANGLE_TOL = 1e-9  # tests/test_native.py's bound
CHAIN_TOL = 1e-8


@pytest.fixture(scope="module")
def libs():
    if not native.available():
        pytest.skip("the native engine did not build (no g++ or make)")
    if not j_native.available():
        pytest.skip("the JAX package's native engine did not build")
    return native, j_native


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _van_der_pol(y):
    return np.array([y[1], 2.0 * (1.0 - y[0] ** 2) * y[1] - y[0]])


def _call(mod, name, rng):
    """One call of ``mod.name`` on inputs drawn from ``rng``."""
    if name == "rkf45_evolve_times":
        return mod.rkf45_evolve_times(_van_der_pol, rng.normal(size=2),
                                      np.linspace(0.0, 3.0, 7), eps_abs=1e-10)
    if name == "double_pendulum_evolve":
        return mod.double_pendulum_evolve(1.3, 0.7, rng.normal(size=4) * 0.5, TS)
    if name == "chain_evolve":
        return mod.chain_evolve(rng.uniform(0.5, 2.0, 4), 0.3 * rng.normal(size=8), TS,
                                link_length=0.8, gravity=9.8, eps_abs=1e-12, eps_rel=1e-12)
    if name == "chain_ensemble_fixed_steps":
        return mod.chain_ensemble_fixed_steps(rng.uniform(0.5, 2.0, 5),
                                              0.3 * rng.normal(size=(6, 10)), 1e-3, 200,
                                              link_length=1.1, gravity=4.0)
    return mod.double_pendulum_fixed_steps(0.9, 1.1, 1e-3, 500, rng.normal(size=4))


@pytest.mark.parametrize("name", ["rkf45_evolve_times", "double_pendulum_evolve",
                                  "chain_evolve", "chain_ensemble_fixed_steps",
                                  "double_pendulum_fixed_steps"])
def test_binding_equals_the_reference_binding_bit_for_bit(libs, name):
    port, ref = libs
    got = _call(port, name, np.random.default_rng(11))
    want = _call(ref, name, np.random.default_rng(11))
    if isinstance(want, tuple):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    else:
        np.testing.assert_array_equal(got, want)


def test_public_functions_and_constant():
    assert native.GSL_EPS_DEFAULT == j_native.GSL_EPS_DEFAULT
    for name in ("available", "load", "rkf45_evolve_times", "double_pendulum_evolve",
                 "chain_evolve", "chain_ensemble_fixed_steps", "double_pendulum_fixed_steps"):
        assert callable(getattr(native, name)), name


# ----------------------------------------------------------------------
# The parity triangle on the port
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def triangle(libs):
    """The three runs of the double pendulum at q0 = (1, 0), v0 = (0, 0.5)
    over ts = 0, 0.1, ..., 1.0: ``{name: (len(ts), 4) array}``."""
    ex = tp.double_pendulum(device="cpu", dtype=F64)
    ph0 = tp.to_phase(ex.system, tp.Config(torch.tensor([1.0, 0.0], dtype=F64),
                                           torch.tensor([0.0, 0.5], dtype=F64)))
    y0 = ph0.flatten().numpy()
    port = tp.evolve_ham(ex.system, ph0, TS.tolist(), method="rkf45")
    rhs = ham_rhs(ex.system)
    callback, stats = native.rkf45_evolve_times(
        lambda y: rhs(torch.from_numpy(y.copy())).numpy(), y0, TS)
    analytic, _ = native.double_pendulum_evolve(1.0, 1.0, y0, TS)
    assert stats["n_steps"] > 10
    return {"port": torch.cat([port.q, port.p], -1).numpy(), "callback": callback,
            "analytic": analytic}


@pytest.mark.parametrize("pair", [("port", "callback"), ("callback", "analytic"),
                                  ("port", "analytic")], ids="-".join)
def test_parity_triangle(triangle, pair):
    a, b = pair
    np.testing.assert_allclose(triangle[a], triangle[b], rtol=0, atol=TRIANGLE_TOL)


# ----------------------------------------------------------------------
# The port's AD chain against the closed-form chain
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n, masses, theta0, ts", [
    (5, None, 0.5, np.linspace(0.0, 1.0, 11)),
    (3, (2.0, 1.0, 0.5), 0.4, np.array([0.0, 0.5])),
], ids=["n5", "n3-masses"])
def test_ad_chain_matches_closed_form_chain(libs, n, masses, theta0, ts):
    ex = tp.chain(n_links=n, masses=masses, theta0=theta0, device="cpu", dtype=F64)
    out = tp.evolve_ham(ex.system, ex.init_phase, ts.tolist(), method="rkf45")
    nat, stats = native.chain_evolve(np.ones(n) if masses is None else np.asarray(masses),
                                     ex.init_phase.flatten().numpy(), ts)
    np.testing.assert_allclose(out.q.numpy(), nat[:, :n], rtol=0, atol=CHAIN_TOL)
    np.testing.assert_allclose(out.p.numpy(), nat[:, n:], rtol=0, atol=CHAIN_TOL)
    assert stats["n_steps"] > (5 if masses is None else 0)


def test_chain20_gap_sets_the_card_bound(libs):
    """8 members of phase 8's batch (16384 × chain-20, jittered with seed 0)
    over t ∈ [0, 1] at GSL's eps, one shared controller: the JAX package's
    and the port's ``evolve_ham`` against ``chain_evolve`` at eps 1e-13.  The
    port's gap stays within 10 times the JAX package's, and chip_smoke's
    bound for the card's run is 10 times the JAX package's gap."""
    cs = _chip_smoke()
    n = 20
    tex = tp.chain(n_links=n, device="cpu", dtype=F64)
    batch = cs.jittered_phase(tex, cs.BATCH, F64, "cpu", cs.ADAPTIVE_SEED)
    members = cs.oracle_members(cs.BATCH)
    q0, p0 = batch.q[members].numpy(), batch.p[members].numpy()
    ts = np.array([0.0, 1.0])
    nat = np.stack([native.chain_evolve(np.ones(n), np.concatenate([q, p]), ts,
                                        eps_abs=cs.ORACLE_EPS, eps_rel=cs.ORACLE_EPS)[0][1]
                    for q, p in zip(q0, p0)])

    def gap(q, p):
        return max(np.abs(q - nat[:, :n]).max(), np.abs(p - nat[:, n:]).max())

    jex = j_chain(n_links=n)
    ref = ht.evolve_ham(jex.system, ht.Phase(jnp.asarray(q0), jnp.asarray(p0)),
                        jnp.asarray(ts))
    out = tp.evolve_ham(tex.system, tp.Phase(torch.tensor(q0), torch.tensor(p0)), ts.tolist())
    jax_gap = gap(np.asarray(ref.q[1]), np.asarray(ref.p[1]))
    port_gap = gap(out.q[1].numpy(), out.p[1].numpy())
    assert 0 < jax_gap < 1e-5, jax_gap
    assert port_gap <= 10 * jax_gap, (port_gap, jax_gap)
    assert math.isclose(cs.ORACLE_CHAIN20_BOUND, 10 * jax_gap, rel_tol=0.01), (
        cs.ORACLE_CHAIN20_BOUND, jax_gap)


# ----------------------------------------------------------------------
# The engine itself
# ----------------------------------------------------------------------

def test_chain_ensemble_runner_replicates(libs):
    n, members = 4, 8
    y0 = np.concatenate([np.full(n, 0.3), np.zeros(n)])
    out = native.chain_ensemble_fixed_steps(np.ones(n), np.tile(y0, (members, 1)), 1e-3, 500)
    assert out.shape == (members, 2 * n)
    assert np.all(np.isfinite(out))
    for m in range(1, members):
        np.testing.assert_array_equal(out[m], out[0])


def test_too_few_times_rejected(libs):
    with pytest.raises(RuntimeError):
        native.rkf45_evolve_times(lambda y: -y, np.array([1.0]), np.array([0.0]))


def test_library_lands_in_the_ports_build_directory(libs):
    lib = Path(native.load()._name).resolve()
    assert lib.parent == (REPO / "hamilton_tpu_torch" / "_build" / "native").resolve()
    assert lib.name.startswith("libhamode-") and lib.suffix == ".so"
    assert lib.parent != (REPO / "native" / "build").resolve()
