"""The port's Poincaré sections, diagnostics and checkpoints
(``hamilton_tpu_torch/utils/poincare.py``, ``diagnostics.py``,
``checkpoint.py``) against the JAX package's, on the CPU.

The same numpy inputs from a seed go through both packages in float64:
sections to 1e-12 with the same mask (the same operations: in practice
equal), the sentinels' booleans equal, the guards' errors with the same
message, and checkpoint files that cross between the packages bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from hamilton_tpu import models as jmodels
from hamilton_tpu.integrators.evolve import evolve_ham_fixed as j_fixed
from hamilton_tpu.state import Phase as JPhase
from hamilton_tpu.utils import checkpoint as jckpt
from hamilton_tpu.utils import diagnostics as jdiag
from hamilton_tpu.utils import poincare as jpoin

import hamilton_tpu_torch as tp
from hamilton_tpu_torch.integrators.fixed import make_stepper
from hamilton_tpu_torch.state import Phase
from hamilton_tpu_torch.utils import checkpoint as tckpt
from hamilton_tpu_torch.utils import diagnostics as tdiag
from hamilton_tpu_torch.utils import poincare as tpoin

F64 = torch.float64
TOL = 1e-12


def _both(q, p):
    return JPhase(jnp.asarray(q), jnp.asarray(p)), Phase(torch.tensor(q), torch.tensor(p))


def _same_section(jtraj, ttraj, section_args, cap):
    jpts, jv = jpoin.poincare_section(jtraj, jpoin.coordinate_section(*section_args),
                                      max_crossings=cap)
    tpts, tv = tpoin.poincare_section(ttraj, tpoin.coordinate_section(*section_args),
                                      max_crossings=cap)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_allclose(tpts.q.numpy(), np.asarray(jpts.q), rtol=0, atol=TOL)
    np.testing.assert_allclose(tpts.p.numpy(), np.asarray(jpts.p), rtol=0, atol=TOL)
    assert tpts.q.dtype == F64 and tv.dtype == torch.bool
    return tv


@pytest.mark.parametrize("direction", [+1, -1])
def test_pendulum_half_period_sections(direction):
    """The pendulum through θ = 0 upward (+1) and downward (-1): one crossing
    a period each, half a period apart, on the reference's gauss4 trajectory
    (time, n)."""
    ex = jmodels.pendulum(theta0=0.4, omega0=0.0)
    traj = j_fixed(ex.system, ex.init_phase, 0.01, 2000, method="gauss4", emit_every=4)
    q, p = np.asarray(traj.q), np.asarray(traj.p)
    jtraj, ttraj = _both(q, p)
    valid = _same_section(jtraj, ttraj, (0, 0.0, direction), 8)
    assert 2 <= int(valid.sum()) < 8


def test_batched_sections_and_the_overflow_contract():
    """A (time, B, n) trajectory, members crossing at their own rates, the
    plane q[1] = 0.2; then a cap below some members' counts: their first
    crossings kept, their masks all True (the reference's truncation
    contract), the others' unchanged."""
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 20.0, 801)[:, None]
    omega = rng.uniform(0.5, 3.0, (1, 6))
    phase = rng.uniform(0.0, 2 * np.pi, (1, 6))
    q = np.stack([np.cos(omega * t + phase), np.sin(omega * t + phase)], axis=-1)
    p = np.stack([-omega * np.sin(omega * t + phase), omega * np.cos(omega * t + phase)],
                 axis=-1)
    jtraj, ttraj = _both(q, p)
    full = _same_section(jtraj, ttraj, (1, 0.2), 16)
    counts = full.sum(0)
    assert counts.max() < 16 and counts.min() != counts.max()
    cap = int(counts.min()) + 1
    capped = _same_section(jtraj, ttraj, (1, 0.2), cap)
    over = counts >= cap
    assert bool(capped[:, over].all()) and bool(over.any())
    assert torch.equal(capped, full[:cap])


def test_sections_in_float32():
    """float32: the 1e-300 of the interpolation is 0, as in the reference."""
    rng = np.random.default_rng(1)
    q = np.cumsum(0.1 * rng.standard_normal((200, 4, 2)), axis=0).astype(np.float32)
    p = rng.standard_normal((200, 4, 2)).astype(np.float32)
    jtraj, ttraj = _both(q, p)
    jpts, jv = jpoin.poincare_section(jtraj, jpoin.coordinate_section(0), max_crossings=12)
    tpts, tv = tpoin.poincare_section(ttraj, tpoin.coordinate_section(0), max_crossings=12)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_allclose(tpts.q.numpy(), np.asarray(jpts.q), rtol=0, atol=1e-6)


def test_finite_phase_and_energy_sentinel():
    """``check_finite_phase`` and ``energy_sentinel`` on the same phases:
    finite, one NaN member, an energy blown past ``tol``."""
    jsys = jmodels.double_pendulum().system
    tsys = tp.double_pendulum(device="cpu", dtype=F64).system
    rng = np.random.default_rng(2)
    q = np.array([1.2, 0.3]) + 0.1 * rng.standard_normal((8, 2))
    p = 0.3 * rng.standard_normal((8, 2))
    jph, tph = _both(q, p)
    jh0 = jax.vmap(lambda ph: jdiag.hamiltonian(jsys, ph))(jph)
    th0 = tp.hamiltonian(tsys, tph)
    for scale, tol in ((1.0, 1e3), (40.0, 1e3), (40.0, 1e6)):
        jb, tb = _both(q, scale * p)
        assert bool(jdiag.check_finite_phase(jb)) == bool(tdiag.check_finite_phase(tb))
        want = bool(jdiag.energy_sentinel(jsys, jb, jh0, tol=tol))
        assert want == bool(tdiag.energy_sentinel(tsys, tb, th0, tol=tol)), (scale, tol)
    assert bool(tdiag.energy_sentinel(tsys, Phase(tph.q[0], tph.p[0]), th0[0]))
    bad = p.copy()
    bad[3, 1] = np.nan
    jb, tb = _both(q, bad)
    assert not bool(jdiag.check_finite_phase(jb)) and not bool(tdiag.check_finite_phase(tb))


def _poisoned_loop(guard, step, ph, poison_at):
    """50 steps of ``step``, the state guarded after each; member 2 of the
    state turned NaN at step ``poison_at``."""
    for i in range(50):
        ph = step(ph, i == poison_at)
        ph = guard(ph, f"step {i}")
    return ph


def _message(fn, *args):
    with pytest.raises(Exception) as info:
        fn(*args)
    return str(info.value).split(" (`check` failed)")[0]


def test_nan_guard_in_a_50_step_loop():
    """``checked`` over a 50-step loop of the port's library leapfrog with
    ``nan_guard`` after each step: the first failing guard's ``where`` in
    the error, as the reference's checkify error (on its loop of the same
    shape) names it; a clean run returns the state; outside ``checked`` the
    guard raises at once."""
    tsys = tp.double_pendulum(device="cpu", dtype=F64).system
    st = make_stepper(tsys, "leapfrog", iters=(2, 1))
    q = np.array([[1.2, 0.3], [0.4, -0.2], [0.9, 0.1], [0.2, 0.5]])
    ph0 = Phase(torch.tensor(q), torch.zeros(4, 2, dtype=F64))
    dt = torch.tensor(1e-3, dtype=F64)
    poison = torch.zeros(4, 1, dtype=F64)
    poison[2] = float("nan")

    def tstep(ph, bad):
        ph = st.extract(st.step(st.init(ph), dt))
        return Phase(ph.q + poison, ph.p) if bad else ph

    def jstep(ph, bad):
        ph = JPhase(ph.q + 1e-3 * ph.p, ph.p - 1e-3 * jnp.sin(ph.q))
        return JPhase(ph.q + jnp.asarray(poison.numpy()), ph.p) if bad else ph

    out = tdiag.checked(_poisoned_loop)(tdiag.nan_guard, tstep, ph0, -1)
    assert bool(tdiag.check_finite_phase(out))
    jph0 = JPhase(jnp.asarray(q), jnp.zeros((4, 2)))
    for at in (0, 31, 49):
        want = _message(jdiag.checked(lambda p: _poisoned_loop(jdiag.nan_guard, jstep, p, at)),
                        jph0)
        got = _message(tdiag.checked(_poisoned_loop), tdiag.nan_guard, tstep, ph0, at)
        assert got == want == f"non-finite state detected at step {at}"
    nan_ph = Phase(ph0.q + poison, ph0.p)
    assert _message(tdiag.nan_guard, nan_ph, "eager") == _message(
        jdiag.nan_guard, JPhase(jnp.asarray(nan_ph.q.numpy()), jph0.p), "eager")
    assert tdiag.nan_guard(ph0, "eager") is ph0


def test_float_checks_mode():
    """``errors=float_checks``: a NaN made by an op and a division by zero
    raise with the reference's messages; the user's guards are not checked
    in that mode (as checkify drops them); ``all_checks`` does both."""
    x = np.array([-1.0, 2.0])

    def jlog(v):
        return jnp.log(v) * 2.0

    def tlog(v):
        return torch.log(v) * 2.0

    for jf, tf, arg in ((jlog, tlog, x), (lambda v: v / 0.0, lambda v: v / 0.0, x[1:])):
        want = _message(jdiag.checked(jf, errors=checkify.float_checks), jnp.asarray(arg))
        got = _message(tdiag.checked(tf, errors=tdiag.float_checks), torch.tensor(arg))
        assert got == want
    assert _message(tdiag.checked(tlog, errors=tdiag.float_checks),
                    torch.tensor(x)) == "nan generated by primitive: log."
    nan_ph = Phase(torch.tensor([1.0, float("nan")]), torch.zeros(2, dtype=F64))
    tdiag.checked(lambda ph: tdiag.nan_guard(ph, "g"), errors=tdiag.float_checks)(nan_ph)
    assert _message(tdiag.checked(lambda ph: tdiag.nan_guard(ph, "g"),
                                  errors=tdiag.all_checks), nan_ph) == (
        "non-finite state detected at g")
    assert torch.equal(tdiag.checked(tlog, errors=tdiag.float_checks)(torch.tensor([1.0, 2.0])),
                       torch.log(torch.tensor([1.0, 2.0])) * 2.0)


def _bits(a):
    a = np.asarray(a)
    return a.dtype, a.shape, a.tobytes()


def test_checkpoint_round_trip_and_resume(tmp_path):
    """A Phase, a nested state with ``like=`` (dict, tuple, list,
    NamedTuple, None), and the library leapfrog's carry: saved and loaded
    bit for bit, dtypes kept; the resume from step 5 equals the straight 10
    steps bit for bit."""
    rng = np.random.default_rng(3)
    ph = Phase(torch.tensor(rng.standard_normal((4, 2))), torch.tensor(rng.standard_normal((4, 2))))
    path = str(tmp_path / "a.npz")
    tckpt.save_checkpoint(path, ph, step=7, extra={"note": "x"})
    back, step, extra = tckpt.load_checkpoint(path, device="cpu")
    assert isinstance(back, Phase) and step == 7 and extra == {"note": "x"}
    assert torch.equal(back.q, ph.q) and torch.equal(back.p, ph.p)

    carry = make_stepper(tp.double_pendulum(device="cpu", dtype=F64).system, "tao2").init(ph)
    nested = {"b": (ph, [torch.arange(3), None]), "a": carry,
              "c": torch.tensor(rng.standard_normal(5), dtype=torch.float32)}
    tckpt.save_checkpoint(path, nested)
    back, _, _ = tckpt.load_checkpoint(path, like=nested)
    assert type(back["a"]) is type(carry) and back["b"][1][1] is None
    flat_in, flat_out = [], []
    tckpt._flatten(nested, flat_in)
    tckpt._flatten(back, flat_out)
    assert [_bits(a) for a in flat_in] == [_bits(b) for b in flat_out]
    assert back["c"].dtype == torch.float32 and back["b"][1][0].dtype == torch.int64
    plain, _, _ = tckpt.load_checkpoint(path, device="cpu")
    assert isinstance(plain, list) and len(plain) == len(flat_in)

    system = tp.double_pendulum(device="cpu", dtype=F64).system
    st = make_stepper(system, "leapfrog", iters=(3, 1))
    dt = torch.tensor(1e-3, dtype=F64)
    c = st.init(ph)
    for _ in range(5):
        c = st.step(c, dt)
    tckpt.save_checkpoint(path, c, step=5)
    straight = c
    for _ in range(5):
        straight = st.step(straight, dt)
    resumed, step, _ = tckpt.load_checkpoint(path, like=c)
    for _ in range(10 - step):
        resumed = st.step(resumed, dt)
    a, b = st.extract(straight), st.extract(resumed)
    assert torch.equal(a.q, b.q) and torch.equal(a.p, b.p)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A file the JAX package writes loads in the port bit for bit, and the
    reverse: a bare Phase both ways (no ``like=``), and a nested state of
    dicts, tuples and lists with ``like=`` on each side."""
    rng = np.random.default_rng(4)
    q, p = rng.standard_normal((3, 2)), rng.standard_normal((3, 2))
    jph, tph = _both(q, p)
    path = str(tmp_path / "j.npz")
    jckpt.save_checkpoint(path, jph, step=3, extra={"k": 1})
    got, step, extra = tckpt.load_checkpoint(path, device="cpu")
    assert isinstance(got, Phase) and (step, extra) == (3, {"k": 1})
    assert _bits(got.q) == _bits(q) and _bits(got.p) == _bits(p)
    path = str(tmp_path / "t.npz")
    tckpt.save_checkpoint(path, tph, step=4)
    got, step, _ = jckpt.load_checkpoint(path)
    assert isinstance(got, JPhase) and step == 4
    assert _bits(got.q) == _bits(q) and _bits(got.p) == _bits(p)

    w = rng.standard_normal(4).astype(np.float32)
    jstate = {"z": [jnp.asarray(w), (jph, jnp.arange(2))], "a": jnp.asarray(q[0])}
    tstate = {"z": [torch.tensor(w), (tph, torch.arange(2))], "a": torch.tensor(q[0])}
    jckpt.save_checkpoint(path, jstate)
    got, _, _ = tckpt.load_checkpoint(path, like=tstate)
    assert _bits(got["z"][0]) == _bits(w) and _bits(got["z"][1][0].p) == _bits(p)
    assert _bits(got["a"]) == _bits(q[0]) and got["z"][1][1].tolist() == [0, 1]
    tckpt.save_checkpoint(path, tstate)
    got, _, _ = jckpt.load_checkpoint(path, like=jstate)
    assert _bits(got["z"][0]) == _bits(w) and _bits(got["z"][1][0].q) == _bits(q)
    assert _bits(got["a"]) == _bits(q[0])
