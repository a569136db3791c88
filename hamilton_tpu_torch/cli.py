"""``hamilton-examples-torch`` CLI: subcommand-per-example runner + live
renderer, the port of :mod:`hamilton_tpu.cli`.

Rebuild of the upstream executable (``app/Examples.hs:185-494``): the same
six subcommands with the same flags and defaults (``:195-359``), the same
default example (``doublepend`` with m1=m2=1, ``:196``), the same interactive
keybindings (``:482-494``):

=========  ======================
key        action
=========  ======================
q/Esc/^C   quit
``+``/``-``  zoom ×√2 / ×√½
``>``/``<``  rate ×√2 / ×√½
``]``/``[``  history +5 / −5
=========  ======================

and the same 12-fps ``stepHam(rate/fps)`` loop with a live infobox showing
q, q̇, KE, PE, H (``:414-455``).  Extras, as the JAX package's: ``--method``
to pick the integrator (GSL-parity adaptive ``rkf45`` by default, symplectic
fixed-step options), ``--frames N`` for headless operation, and a ``chain``
subcommand for the N-link stress model.  Where the JAX package takes
``--platform {cpu,default}``, this one takes ``--device``: the card
(``cuda``, the default) or ``cpu`` on request, never the CPU in the card's
place.  It runs in float64 on either (GSL's eps needs it).  The state steps
as a batch of one member, so that on the card each right-hand side's solve
launches the batched kernel (K2a).

Run: ``python -m hamilton_tpu_torch.cli [EXAMPLE] [flags]``.
"""

from __future__ import annotations

import argparse
import ast
import math
import shutil
import sys
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from hamilton_tpu_torch.integrators.evolve import evolve_ham, evolve_ham_fixed
from hamilton_tpu_torch.mechanics import hamiltonian, ke_p, pe, velocities
from hamilton_tpu_torch.models import Example, get_example
from hamilton_tpu_torch.render import PT_STYLES, PlotRange, plot
from hamilton_tpu_torch.state import Phase
from hamilton_tpu_torch.system import underlying_pos

__all__ = ["main", "build_parser", "SimOpts"]

FPS = 12.0  # reference app/Examples.hs:415
SCREEN_RATIO = 2.1  # reference app/Examples.hs:417


@dataclass
class SimOpts:
    """Live simulation options (reference ``SO`` record + initial values
    ``SO 0.5 1 25``, ``app/Examples.hs:361-365,387``)."""

    zoom: float = 0.5
    rate: float = 1.0
    hist: int = 25


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hamilton-examples",
        description=(
            "hamilton-examples - hamilton library example suite.  "
            "Run examples; use [EXAMPLE] --help for per-example options.  "
            "To adjust rate/history/zoom, use keys <>/[]/-+, respectively."
        ),
    )
    p.add_argument(
        "--frames",
        type=int,
        default=None,
        help="headless mode: run N frames and print the final frame + infobox",
    )
    p.add_argument("--no-color", action="store_true", help="disable ANSI colors")
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on: 'cuda' (default; the card) or 'cpu' on "
        "request; float64 on either (the GSL eps 1.49e-08 needs it)",
    )
    p.add_argument(
        "--method",
        default="rkf45",
        help="integrator: rkf45 (GSL-parity adaptive, default), dopri5, or a "
        "fixed-step symplectic method (gauss4, leapfrog, tao4, ...)",
    )
    p.add_argument(
        "--dt",
        type=float,
        default=None,
        help="approximate substep size for fixed-step methods (sets the "
        "per-frame substep count; default rate/fps/32)",
    )
    sub = p.add_subparsers(dest="example", metavar="EXAMPLE")

    dp = sub.add_parser("doublepend", help="Double pendulum (default)")
    dp.add_argument("--m1", type=float, default=1.0, metavar="MASS",
                    help="Mass of first bob (default: 1.0)")
    dp.add_argument("--m2", type=float, default=1.0, metavar="MASS",
                    help="Mass of second bob (default: 1.0)")

    pe_ = sub.add_parser("pend", help="Single pendulum")
    pe_.add_argument("-a", "--angle", type=float, default=0.0, metavar="ANGLE",
                     help="Initial rightward angle (in degrees) of bob (default: 0.0)")
    pe_.add_argument("-v", "--vel", type=float, default=1.0, metavar="VELOCITY",
                     help="Initial rightward angular velocity of bob (default: 1.0)")

    rm = sub.add_parser("room", help="Ball in room, bouncing off of walls")
    rm.add_argument("-a", "--angle", type=float, default=45.0, metavar="ANGLE",
                    help="Initial upward launch angle (in degrees) of object (default: 45.0)")

    tb = sub.add_parser(
        "twobody",
        help="Two-body gravitational simulation.  Note that bodies will only "
        "orbit if H < 0.",
    )
    tb.add_argument("--m1", type=float, default=5.0, metavar="MASS",
                    help="Mass of first body (default: 5.0)")
    tb.add_argument("--m2", type=float, default=0.5, metavar="MASS",
                    help="Mass of second body (default: 0.5)")
    tb.add_argument("-v", "--vel", type=float, default=0.5, metavar="VELOCITY",
                    help="Initial angular velocity of system (default: 0.5)")

    sp = sub.add_parser(
        "spring",
        help="A spring hanging from a block on a rail, holding up a mass.  "
        "Block is constrained to bounce between -1.5 and 1.5.",
    )
    sp.add_argument("-b", "--block", type=float, default=2.0, metavar="MASS",
                    help="Mass of block on rail (default: 2.0)")
    sp.add_argument("-w", "--weight", type=float, default=1.0, metavar="MASS",
                    help="Mass of weight hanging from spring (default: 1.0)")
    sp.add_argument("-k", type=float, default=10.0, metavar="NUM", dest="k",
                    help="Spring constant / stiffness of spring (default: 10.0)")
    sp.add_argument("-x", type=float, default=0.1, metavar="DIST", dest="x",
                    help="Initial displacement of spring (default: 0.1)")

    bz = sub.add_parser("bezier", help="Particle moving along a parameterized bezier curve")
    bz.add_argument(
        "-p", "--points", type=str,
        default="[(-1.0,-1.0),(-2.0,1.0),(0.0,1.0),(1.0,-1.0),(2.0,1.0)]",
        metavar="POINTS",
        help="List of control points (at least one), as tuples "
        "(default: [(-1.0,-1.0),(-2.0,1.0),(0.0,1.0),(1.0,-1.0),(2.0,1.0)])",
    )

    el = sub.add_parser("ellipse", help="Bead on an ellipse under gravity")
    el.add_argument("-a", type=float, default=2.0, metavar="SEMI", dest="a",
                    help="Horizontal semi-axis (default: 2.0)")
    el.add_argument("-b", type=float, default=1.0, metavar="SEMI", dest="b",
                    help="Vertical semi-axis (default: 1.0)")
    el.add_argument("-t", "--theta", type=float, default=2.0, metavar="RAD",
                    help="Initial parameter angle in radians (default: 2.0)")

    sphp = sub.add_parser("spherical", help="Spherical pendulum (3-D)")
    sphp.add_argument("-t", "--theta", type=float, default=1.0, metavar="RAD",
                      help="Initial polar angle in radians (default: 1.0)")
    sphp.add_argument("-v", "--vel", type=float, default=1.0, metavar="RATE",
                      help="Initial azimuthal angular velocity (default: 1.0)")

    ch = sub.add_parser("chain", help="N-link pendulum chain (TPU stress model)")
    ch.add_argument("-n", "--links", type=int, default=20, metavar="N",
                    help="Number of links (default: 20)")
    ch.add_argument("-a", "--angle", type=float, default=0.5, metavar="RAD",
                    help="Initial per-link angle in radians (default: 0.5)")

    return p


def _example_from_args(args) -> Example:
    name = args.example or "doublepend"
    at = dict(device=torch.device(args.device), dtype=torch.float64)
    get = lambda ex, **kw: get_example(ex, **kw, **at)  # noqa: E731
    if name == "doublepend":
        m1 = getattr(args, "m1", 1.0)
        m2 = getattr(args, "m2", 1.0)
        return get("doublepend", m1=m1, m2=m2)
    if name == "pend":
        return get(
            "pend", theta0=args.angle / 180.0 * math.pi, omega0=args.vel
        )
    if name == "room":
        return get("room", theta=args.angle / 180.0 * math.pi)
    if name == "twobody":
        return get("twobody", m1=args.m1, m2=args.m2, omega0=args.vel)
    if name == "spring":
        return get(
            "spring", m_block=args.block, m_weight=args.weight, k=args.k, x0=args.x
        )
    if name == "bezier":
        try:
            pts = ast.literal_eval(args.points)
            pts = [(float(a), float(b)) for a, b in pts]
        except (ValueError, SyntaxError, TypeError) as e:
            raise SystemExit(f"Bad parse for --points: {e}")
        if not pts:
            raise SystemExit("At least one control point required")
        return get("bezier", points=pts)
    if name == "ellipse":
        return get("ellipse", a=args.a, b=args.b, theta0=args.theta)
    if name == "spherical":
        return get("spherical", theta0=args.theta, phi_dot0=args.vel)
    if name == "chain":
        return get("chain", n_links=args.links, theta0=args.angle)
    raise SystemExit(f"unknown example {name!r}")


def _make_step(example: Example, method: str, dt_sub: Optional[float]):
    """Build the per-frame stepper: phase, frame_dt -> phase.

    Adaptive methods mirror the reference exactly — a full adaptive solve per
    frame over [0, rate/fps] (``stepHam``, Hamilton.hs:389-402).  Fixed-step
    symplectic methods subdivide the frame into substeps.  Each frame steps
    the state as a batch of one member (the solves' kernels take a batch)
    and calls the evolution afresh: nothing is compiled or cached.
    """
    system = example.system

    if method in ("rkf45", "dopri5", "rkck"):

        def step(ph: Phase, frame_dt: float) -> Phase:
            out = evolve_ham(system, Phase(ph.q[None], ph.p[None]), [0.0, frame_dt],
                             method=method)
            return Phase(out.q[1, 0], out.p[1, 0])

        return step

    # With --dt given, the substep count tracks the *actual* frame advance
    # (rate/FPS — the rate changes interactively via </>), so the effective
    # substep size stays ≈ dt at every rate.
    def step(ph: Phase, frame_dt: float) -> Phase:
        n_sub = _substeps(frame_dt, dt_sub)
        out = evolve_ham_fixed(system, Phase(ph.q[None], ph.p[None]), frame_dt / n_sub,
                               n_sub, method=method, emit_every=n_sub)
        return Phase(out.q[-1, 0], out.p[-1, 0])

    return step


def _substeps(frame_dt: float, dt_sub: Optional[float]) -> int:
    """Substeps a frame of ``frame_dt``: 32, or (``--dt``) about
    ``frame_dt / dt_sub``."""
    return 32 if dt_sub is None else max(1, round(frame_dt / dt_sub))


def _infobox(example: Example, ph: Phase, opts: SimOpts) -> List[str]:
    """The live infobox (reference ``app/Examples.hs:431-455``)."""
    system = example.system
    qvec = ",".join(example.coord_names)
    qs = ", ".join(f"{float(v):.4f}" for v in ph.q)
    vs = ", ".join(f"{float(v):.4f}" for v in velocities(system, ph))
    return [
        f"[ {example.name} ]",
        f" <{qvec}>   : <{qs}>",
        f"d<{qvec}>/dt: <{vs}>",
        f"KE: {float(ke_p(system, ph)):.4f}",
        f"PE: {float(pe(system, ph.q)):.4f}",
        f"H : {float(hamiltonian(system, ph)):.4f}",
        " ",
        f"rate: x{opts.rate:.2f} <>",
        f"hist: {opts.hist:5d} []",
        f"zoom: x{opts.zoom:.2f} -+",
    ]


def _frame_points(example: Example, ph: Phase, history: List[List[tuple]], opts: SimOpts):
    """Current draw points + colored history trail (app/Examples.hs:456-467)."""
    xs = underlying_pos(example.system, ph.q)
    pts = example.draw(xs)
    out = []
    for i, pt in enumerate(pts):
        ch, col = PT_STYLES[i % len(PT_STYLES)]
        x, y = float(pt[0]), float(pt[1])
        while len(history) <= i:
            history.append([])
        history[i] = ([(x, y)] + history[i])[: max(opts.hist, 0)]
        for hx, hy in history[i][1:]:
            out.append((hx, hy, ".", col))
        out.append((x, y, ch, col))
    return out


def _render(example, ph, opts, history, *, width, height, color):
    info = _infobox(example, ph, opts)
    prange = PlotRange.from_x(
        (-1.0 / opts.zoom, 1.0 / opts.zoom), width, height, ratio=SCREEN_RATIO
    )
    pts = _frame_points(example, ph, history, opts)
    lines = plot(width, height, prange, pts, color=color)
    for i, line in enumerate(info):
        if i < len(lines):
            lines[i] = line
    return "\n".join(lines)


def _run_headless(example, args) -> int:
    opts = SimOpts()
    step = _make_step(example, args.method, args.dt)
    ph = example.init_phase
    history: List[List[tuple]] = []
    for _ in range(args.frames):
        ph = step(ph, opts.rate / FPS)
    width, height = 80, 24
    sys.stdout.write(
        _render(example, ph, opts, history, width=width, height=height,
                color=not args.no_color)
        + "\n"
    )
    return 0


def _run_interactive(example, args) -> int:  # pragma: no cover - needs a tty
    import select
    import termios
    import tty

    opts = SimOpts()
    step = _make_step(example, args.method, args.dt)
    ph = example.init_phase
    history: List[List[tuple]] = []

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    sys.stdout.write("\x1b[?1049h\x1b[?25l")  # alt screen, hide cursor
    try:
        tty.setcbreak(fd)
        while True:
            t_frame = time.perf_counter()
            size = shutil.get_terminal_size((80, 24))
            width, height = size.columns, size.lines - 1
            ph = step(ph, opts.rate / FPS)
            frame = _render(example, ph, opts, history, width=width,
                            height=height, color=not args.no_color)
            sys.stdout.write("\x1b[H\x1b[2J" + frame)
            sys.stdout.flush()
            # keybindings (reference processEvt, app/Examples.hs:482-494)
            while select.select([fd], [], [], 0)[0]:
                key = sys.stdin.read(1)
                if key in ("q", "\x1b", "\x03"):
                    return 0
                elif key == "+":
                    opts.zoom *= math.sqrt(2)
                elif key == "-":
                    opts.zoom *= math.sqrt(0.5)
                elif key == ">":
                    opts.rate *= math.sqrt(2)
                elif key == "<":
                    opts.rate *= math.sqrt(0.5)
                elif key == "]":
                    opts.hist += 5
                elif key == "[":
                    opts.hist -= 5
            elapsed = time.perf_counter() - t_frame
            time.sleep(max(1.0 / FPS - elapsed, 0.0))
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[?25h\x1b[?1049l")
        sys.stdout.flush()


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("hamilton-examples-torch: no CUDA device; pass --device cpu to "
                         "run on the CPU")
    # The reference runs Double throughout, and the default rkf45 method's
    # GSL tolerance (1.49012e-08) sits below f32 machine epsilon — in f32
    # the adaptive error test can never pass.  Both devices run float64.
    example = _example_from_args(args)
    if args.frames is not None:
        return _run_headless(example, args)
    if not sys.stdin.isatty():
        print(
            "stdin is not a tty; use --frames N for headless mode",
            file=sys.stderr,
        )
        return 2
    return _run_interactive(example, args)


if __name__ == "__main__":
    sys.exit(main())
