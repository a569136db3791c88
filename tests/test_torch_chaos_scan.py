"""The port's chaos scan (``hamilton_tpu_torch/examples/chaos_scan.py``)
against the JAX package's, on the CPU.

``chaos_map``'s λ grid (8 × 4 cells) equals the reference's
``evolve_ensemble_final`` + ``LyapunovPairs`` on the same ensemble (the
reference's ``examples/chaos_scan.py`` computation): the library leapfrog in
float64, the fused path (the plain K1 here, the reference's kernel
interpreted) in float64 and in float32; ``main`` prints the map and exits 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from hamilton_tpu.ensemble import evolve_ensemble_final as j_final
from hamilton_tpu.models import chain as j_chain
from hamilton_tpu.state import Phase as JPhase
from hamilton_tpu.utils.observables import LyapunovPairs as JPairs

from hamilton_tpu_torch.examples import chaos_scan

# λ over t = steps·dt = 1 from 5 renormalizations in float64: each side's
# state is good to ~1e-14 after 200 steps, ~1e-7 of the pairs' 1e-7
# separation (readings 1.2e-7, library and fused).  In float32 an ulp of the
# state is ~1e-3 of the pairs' 1e-4 separation, a noise each renormalization
# adds to λ: three float32 implementations (the reference's interpreted
# kernel, the port's plain fused step and its library leapfrog) differ from
# each other by 1.1e-2 to 1.3e-2 over the first 40-step span and by 3e-2 to
# 7.5e-2 over 200 steps, so float32 is held over one span, to 3e-2.
LAMBDA_TOL = {"float64": 1e-6, "float32": 3e-2}


def _reference_lambda(rows, cols, steps, fused, dtype=None):
    """The reference's chaos scan (``examples/chaos_scan.py``): λ on the
    grid; its fused kernel takes batches of 1024 members, so there the pairs
    are padded to 1024 with copies of the first, as the example pads them,
    and the padding dropped."""
    if dtype is None:
        dtype = jnp.float32 if fused else jnp.float64
    eps = 1e-4 if dtype == jnp.float32 else 1e-7
    b = rows * cols
    ex = j_chain(n_links=2, gravity=5.0)
    theta = jnp.linspace(0.15, jnp.pi - 0.15, cols, dtype=dtype)
    m2 = jnp.linspace(0.2, 3.0, rows, dtype=dtype)
    tg, mg = jnp.meshgrid(theta, m2)
    tg, mg = tg.reshape(-1), mg.reshape(-1)
    q0 = jnp.stack([tg, jnp.zeros_like(tg)], axis=-1)
    ph0 = JPairs.pair_ensemble(JPhase(q0, jnp.zeros_like(q0)), eps)
    pad = (-2 * b) % 1024 if fused else 0

    def rep(x):
        out = jnp.repeat(x, 2, axis=0)
        return jnp.concatenate([out, jnp.broadcast_to(out[:1], (pad,) + x.shape[1:])])

    ph0 = JPhase(jnp.concatenate([ph0.q, jnp.broadcast_to(ph0.q[:1], (pad, 2))]),
                 jnp.concatenate([ph0.p, jnp.broadcast_to(ph0.p[:1], (pad, 2))]))
    sysb = ex.system.replace_params({
        "masses": rep(jnp.stack([jnp.ones_like(mg), mg], axis=-1)),
        "lengths": rep(jnp.broadcast_to(jnp.asarray([1.0, 0.5], dtype), (b, 2))),
        "gravity": rep(jnp.full((b,), 5.0, dtype)),
    })
    lp = JPairs(d0=eps)
    run = dict(method="leapfrog_fused" if fused else "leapfrog", iters=(3, 1),
               track_drift=False, drift_every=steps, observable=lp, obs_every=40,
               steps_per_call=40 if fused else 1)
    if fused:
        with pltpu.force_tpu_interpret_mode():
            _, _, obs = j_final(sysb, ph0, 5e-3, steps, **run)
    else:
        _, _, obs = j_final(sysb, ph0, 5e-3, steps, **run)
    return np.asarray(lp.lyapunov(obs, 5e-3 * steps))[:b].reshape(rows, cols)


CHAOS_CASES = [(False, "float64", 200), (True, "float64", 200), (True, "float32", 40)]


@pytest.mark.parametrize("fused, dname, steps", CHAOS_CASES,
                         ids=["library", "fused float64", "fused float32"])
def test_chaos_map_matches_the_reference(fused, dname, steps):
    """An 8 × 4 grid (64 pair members) at dt = 5e-3: the library leapfrog
    (3,1) in float64 (the example's library mode) and the fused path (40
    steps a launch) in float64 over 200 steps; the fused path in float32
    (the example's ``--fused`` mode) over one 40-step span."""
    rows, cols = 4, 8
    dtype = getattr(torch, dname)
    lam = chaos_scan.chaos_map(rows, cols, steps=steps, fused=fused, device="cpu", dtype=dtype)
    assert lam.shape == (rows, cols) and lam.dtype == dtype
    want = _reference_lambda(rows, cols, steps, fused, getattr(jnp, dname))
    np.testing.assert_allclose(lam.numpy(), want, rtol=0, atol=LAMBDA_TOL[dname])


def test_chaos_scan_main():
    """``main`` on a small grid on the CPU: the heat map, and exit 0 (the
    large angles more chaotic than the small ones)."""
    assert chaos_scan.main(["--cols", "8", "--rows", "4", "--steps", "400", "--fused",
                            "--device", "cpu"]) == 0


