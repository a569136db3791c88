"""The port's CLI (``hamilton_tpu_torch/cli.py``) and renderer
(``hamilton_tpu_torch/render.py``) against the JAX package's, on the CPU.

The parser is the reference's flag for flag, but for ``--platform``, which
is ``--device`` here (the card by default, the CPU on request); the renderer
is the reference's string for string; each subcommand's headless frames
(``--frames 3 --device cpu``) end on the reference's ``_make_step`` state to
1e-10 and print the reference's text.  The second half of the subcommands
is in ``test_torch_cli_frames.py``.
"""

import argparse
import os
import re
import select
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hamilton_tpu import cli as jcli
from hamilton_tpu import render as jrender

from hamilton_tpu_torch import cli as tcli
from hamilton_tpu_torch import render as trender

REPO = Path(__file__).resolve().parent.parent
FRAME_TOL = 1e-10

#: (argv after the flags, final-state tolerance): the subcommands and their
#: defaults; ``test_torch_cli_frames.py`` takes the second list.
FRAMES_A = [[], ["doublepend", "--m1", "1.3"], ["pend", "-a", "10"], ["room"], ["twobody"]]
FRAMES_B = [["spring"], ["bezier"], ["ellipse"], ["spherical"], ["chain", "-n", "20"],
            ["--method", "gauss4", "doublepend"], ["--method", "leapfrog", "--dt", "0.002",
                                                     "pend"]]


def _actions(parser):
    """Every argument of a parser and its subparsers: (subcommand, option
    strings, dest, default, type, nargs, choices, metavar, help)."""
    out = []
    for act in parser._actions:
        if isinstance(act, argparse._SubParsersAction):
            for name, sub in act.choices.items():
                out += [(name,) + a[1:] for a in _actions(sub)]
            out.append(("", "subcommands", tuple(act.choices), act.dest, act.metavar))
            continue
        out.append(("", tuple(act.option_strings), act.dest, act.default, act.type,
                    act.nargs, act.choices, act.metavar, act.help))
    return out


def test_parser_matches_the_reference():
    """Every subcommand, flag and default of ``build_parser()`` equals the
    reference's, except ``--platform {cpu,default}`` (default cpu), which is
    ``--device`` (default cuda) here."""
    ref = [a for a in _actions(jcli.build_parser()) if a[1] != ("--platform",)]
    port = [a for a in _actions(tcli.build_parser()) if a[1] != ("--device",)]
    assert port == ref
    dev = next(a for a in tcli.build_parser()._actions if a.dest == "device")
    assert dev.option_strings == ["--device"] and dev.default == "cuda"
    assert tcli.build_parser().prog == jcli.build_parser().prog
    assert (tcli.FPS, tcli.SCREEN_RATIO, tcli.SimOpts()) == (jcli.FPS, jcli.SCREEN_RATIO,
                                                             tcli.SimOpts(**vars(jcli.SimOpts())))


def test_render_matches_the_reference():
    """``plot``, ``render_frame``, ``PlotRange.from_x``, the styles and the
    colors: the same strings on the same points."""
    rng = np.random.default_rng(0)
    assert trender.PT_STYLES == jrender.PT_STYLES and trender.__all__ == jrender.__all__
    for name in ("white", "red", "reset", "nope"):
        assert trender.ansi_color(name) == jrender.ansi_color(name)
    for wd, ht, xr in ((80, 24, (-2.0, 2.0)), (37, 11, (-0.7, 1.3)), (120, 40, (-5.0, 5.0))):
        pts = [(float(x), float(y), ch, col) for (x, y), (ch, col) in
               zip(rng.uniform(-2.5, 2.5, (30, 2)), jrender.PT_STYLES * 2)]
        tr, jr = trender.PlotRange.from_x(xr, wd, ht), jrender.PlotRange.from_x(xr, wd, ht)
        assert (tr.xmin, tr.xmax, tr.ymin, tr.ymax) == (jr.xmin, jr.xmax, jr.ymin, jr.ymax)
        for color in (True, False):
            tl = trender.plot(wd, ht, tr, pts, color=color)
            assert tl == jrender.plot(wd, ht, jr, pts, color=color)
            info = ["[ x ]", "KE: 1.0000", "a longer line of the infobox, past the plot"]
            assert trender.render_frame(info, tl) == jrender.render_frame(info, tl)
    assert trender.plot(10, 4, trender.PlotRange(0.0, 0.0, 0.0, 1.0), []) == [""] * 4


def _frames(argv, frames=3):
    """Both packages' headless run of ``argv``: ``(port phase, reference
    phase, port text, reference text)`` after ``frames`` frames at rate 1."""
    jargs = jcli.build_parser().parse_args(argv)
    targs = tcli.build_parser().parse_args(["--device", "cpu"] + argv)
    jex, tex = jcli._example_from_args(jargs), tcli._example_from_args(targs)
    jstep = jcli._make_step(jex, jargs.method, jargs.dt)
    tstep = tcli._make_step(tex, targs.method, targs.dt)
    jph, tph = jex.init_phase, tex.init_phase
    for _ in range(frames):
        jph = jstep(jph, 1.0 / jcli.FPS)
        tph = tstep(tph, 1.0 / tcli.FPS)
    kw = dict(width=80, height=24, color=False)
    ttext = tcli._render(tex, tph, tcli.SimOpts(), [], **kw)
    jtext = jcli._render(jex, jph, jcli.SimOpts(), [], **kw)
    return tph, jph, ttext, jtext


def _unsigned_zeros(text):
    """``-0.0000`` as ``0.0000``: a value within rounding of zero prints
    with the sign of its last ulps, which the two packages need not share."""
    return re.sub(r"-(0\.0+)(?!\d)", r"\1", text)


def check_frames(argv):
    tph, jph, ttext, jtext = _frames(argv)
    assert tph.q.dtype == torch.float64 and tph.q.shape == jph.q.shape
    np.testing.assert_allclose(tph.q.numpy(), np.asarray(jph.q), rtol=0, atol=FRAME_TOL)
    np.testing.assert_allclose(tph.p.numpy(), np.asarray(jph.p), rtol=0, atol=FRAME_TOL)
    assert _unsigned_zeros(ttext) == _unsigned_zeros(jtext)


@pytest.mark.parametrize("argv", FRAMES_A, ids=[" ".join(a) or "default" for a in FRAMES_A])
def test_headless_frames_match_the_reference(argv):
    """Three frames of each subcommand (default ``rkf45``): the reference's
    final state to 1e-10 and its rendered frame (a zero's sign aside)."""
    check_frames(argv)


def test_main_prints_the_reference_frame(capsys):
    """``main(["--frames", "3", "--no-color", "--device", "cpu", "pend",
    "-a", "10"])`` prints the infobox and plot the reference's ``main``
    prints."""
    argv = ["--frames", "3", "--no-color", "pend", "-a", "10"]
    assert tcli.main(["--device", "cpu"] + argv) == 0
    port = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert port == capsys.readouterr().out
    assert port.startswith("[ Single pendulum ]\n")


def test_substeps_track_the_rate():
    """With ``--dt`` the substep count follows the frame's advance rate/FPS
    (after ``<``/``>`` too): each frame equals ``evolve_ham_fixed`` over
    ``round(frame_dt / dt)`` substeps, and the reference's step (the
    counterpart of its slow-marked ``test_dt_honored_at_any_rate``)."""
    from hamilton_tpu.models import double_pendulum as jdp
    from hamilton_tpu_torch.integrators.evolve import evolve_ham_fixed
    from hamilton_tpu_torch.models import double_pendulum
    from hamilton_tpu_torch.state import Phase

    ex, jex = double_pendulum(device="cpu", dtype=torch.float64), jdp()
    dt_req = 4e-3
    step, jstep = tcli._make_step(ex, "leapfrog", dt_req), jcli._make_step(jex, "leapfrog", dt_req)
    for rate in (1.0, 2.37):
        frame_dt = rate / tcli.FPS
        got = step(ex.init_phase, frame_dt)
        n_sub = max(1, round(frame_dt / dt_req))
        assert tcli._substeps(frame_dt, dt_req) == n_sub
        assert abs(frame_dt / n_sub - dt_req) <= dt_req / n_sub
        ph = ex.init_phase
        want = evolve_ham_fixed(ex.system, Phase(ph.q[None], ph.p[None]), frame_dt / n_sub,
                                n_sub, method="leapfrog", emit_every=n_sub)
        assert torch.equal(got.q, want.q[-1, 0]) and torch.equal(got.p, want.p[-1, 0])
        np.testing.assert_allclose(got.q.numpy(), np.asarray(jstep(jex.init_phase, frame_dt).q),
                                   rtol=0, atol=1e-12)
    assert tcli._substeps(1.0 / tcli.FPS, None) == 32


def test_without_a_card_it_asks_for_the_cpu(capsys):
    """No card and no ``--device cpu``: a message naming ``--device cpu``,
    nothing run on the CPU; no tty and no ``--frames``: the reference's
    message."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        tcli.main(["--frames", "1", "pend"])
    proc = subprocess.run([sys.executable, "-m", "hamilton_tpu_torch.cli", "--device", "cpu"],
                          capture_output=True, text=True, stdin=subprocess.DEVNULL, cwd=REPO,
                          timeout=120)
    assert proc.returncode == 2 and "use --frames N for headless mode" in proc.stderr


def test_interactive_loop_keys_and_quit():
    """The interactive loop through a pseudo-tty with ``--device cpu``:
    frames render, ``+`` applies the sqrt-2 zoom, ``q`` exits cleanly and
    restores the screen."""
    import pty

    master, slave = pty.openpty()
    env = dict(os.environ, TERM="xterm-256color", COLUMNS="80", LINES="24",
               PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "hamilton_tpu_torch.cli", "--device", "cpu", "pend", "-a", "20"],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE, env=env, close_fds=True, cwd=REPO,
    )
    os.close(slave)
    out = b""
    sent = False
    t0 = time.time()
    try:
        while time.time() - t0 < 120 and proc.poll() is None:
            r, _, _ = select.select([master], [], [], 0.5)
            if not r:
                continue
            try:
                out += os.read(master, 65536)
            except OSError:
                break
            if b"H :" in out and not sent:
                os.write(master, b"+")
                time.sleep(0.5)
                os.write(master, b"q")
                sent = True
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
        os.close(master)
    assert rc == 0, proc.stderr.read().decode()[-500:]
    assert b"\x1b[?1049h" in out and b"\x1b[?1049l" in out
    assert b"[ Single pendulum ]" in out
    zooms = {z.decode() for z in re.findall(rb"zoom: x(\d+\.\d+)", out)}
    assert "0.71" in zooms, zooms  # 0.5 * sqrt(2)
