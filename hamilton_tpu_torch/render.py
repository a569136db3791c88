"""ANSI terminal scatter-plot renderer (the port's own copy of
:mod:`hamilton_tpu.render`, which is pure Python: the port imports nothing
of the JAX package).

Rebuild of the upstream vty plotting layer
(``app/Examples.hs:496-566``): an ASCII scatter plot with centered axes, an
origin marker, numeric range labels at the axis extremes, terminal
character-aspect-ratio handling (the reference's ``screenRatio = 2.1``,
``app/Examples.hs:417``), and crop-to-bounds; point styles cycle through the
reference's chars/colors (``ptChars = "o*+~"``, colors
white/yellow/blue/red/green, ``app/Examples.hs:418-421``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

__all__ = ["PlotRange", "Point", "render_frame", "plot", "PT_STYLES", "ansi_color"]

# The reference's point style cycle (app/Examples.hs:418-421).
_COLORS = ("white", "yellow", "blue", "red", "green")
_CHARS = "o*+~"
PT_STYLES = [( _CHARS[i % len(_CHARS)], _COLORS[i % len(_COLORS)]) for i in range(20)]

_ANSI = {
    "white": "\x1b[37m",
    "yellow": "\x1b[33m",
    "blue": "\x1b[34m",
    "red": "\x1b[31m",
    "green": "\x1b[32m",
    "reset": "\x1b[0m",
}


def ansi_color(name: str) -> str:
    return _ANSI.get(name, "")


@dataclass(frozen=True)
class PlotRange:
    """Plot bounds derived from an x-range and the terminal aspect ratio.

    Mirror of the reference's ``PX xb (RR 0.5 ratio)`` mode
    (``app/Examples.hs:557-562``): the y-range is derived from the x-range,
    display size, and character aspect ratio, centered at zero offset 0.5.
    """

    xmin: float
    xmax: float
    ymin: float
    ymax: float

    @staticmethod
    def from_x(
        x_range: Tuple[float, float],
        wd: int,
        ht: int,
        *,
        zero: float = 0.5,
        ratio: float = 2.1,
    ) -> "PlotRange":
        xmin, xmax = x_range
        # reference mkRange PX: yr = (xmax−xmin)·ht/wd·ratio; y0 = (zero−1)·yr
        # (note the reference computes `uncurry (-) xb` = xmin−xmax; combined
        # with (zero−1) the result is a centered range — reproduce the net
        # effect: a y-range of that magnitude centered per `zero`.)
        yr = (xmax - xmin) * ht / wd * ratio
        y0 = -zero * yr
        return PlotRange(xmin, xmax, y0, y0 + yr)


Point = Tuple[float, float, str, str]  # x, y, char, color


def plot(
    wd: int,
    ht: int,
    prange: PlotRange,
    points: Sequence[Point],
    *,
    color: bool = True,
) -> List[str]:
    """Render points into ``ht`` lines of width ``wd``.

    Painter's order matches the reference (``app/Examples.hs:516-547``):
    background, axes, origin, labels underneath; points on top (later points
    win).  Row 0 is the top of the screen (y decreasing).
    """
    grid = [[" "] * wd for _ in range(ht)]
    colors = [[None] * wd for _ in range(ht)]

    xr = prange.xmax - prange.xmin
    yr = prange.ymax - prange.ymin
    if xr <= 0 or yr <= 0:
        return ["" for _ in range(ht)]

    def to_cell(x: float, y: float) -> Tuple[int, int]:
        cx = round((x - prange.xmin) * (wd / xr))
        cy = round((y - prange.ymin) * (ht / yr))
        return cx, ht - 1 - cy  # flip: terminal row 0 is top

    # axes through (0, 0)
    ox, oy = to_cell(0.0, 0.0)
    if 0 <= oy < ht:
        for cx in range(wd):
            grid[oy][cx] = "-"
    if 0 <= ox < wd:
        for cy in range(ht):
            grid[cy][ox] = "|"
    if 0 <= oy < ht and 0 <= ox < wd:
        grid[oy][ox] = "+"

    # numeric range labels at the four axis extremes (app/Examples.hs:541-546)
    def put_str(cx: int, cy: int, s: str):
        if not (0 <= cy < ht):
            return
        for i, ch in enumerate(s):
            if 0 <= cx + i < wd:
                grid[cy][cx + i] = ch

    put_str(0, oy, f"{prange.xmin:.2f}")
    lbl = f"{prange.xmax:.2f}"
    put_str(wd - len(lbl), oy, lbl)
    lbl = f"{prange.ymin:.2f}"
    put_str(ox - len(lbl) // 2, ht - 1, lbl)
    lbl = f"{prange.ymax:.2f}"
    put_str(ox - len(lbl) // 2, 0, lbl)

    # points (crop to bounds)
    for x, y, ch, col in points:
        cx, cy = to_cell(x, y)
        if 0 <= cx < wd and 0 <= cy < ht:
            grid[cy][cx] = ch
            colors[cy][cx] = col

    lines = []
    for cy in range(ht):
        if color:
            out = []
            for cx in range(wd):
                col = colors[cy][cx]
                c = grid[cy][cx]
                out.append(f"{_ANSI[col]}{c}{_ANSI['reset']}" if col else c)
            lines.append("".join(out))
        else:
            lines.append("".join(grid[cy]))
    return lines


def render_frame(
    info_lines: Sequence[str],
    plot_lines: Sequence[str],
) -> str:
    """Compose infobox-over-plot into one frame string (the reference layers
    the infobox image above the plot, ``app/Examples.hs:461``)."""
    body = list(plot_lines)
    for i, line in enumerate(info_lines):
        if i < len(body):
            # overlay info text at the left edge of row i
            pad = line
            body[i] = pad + body[i][len(pad):] if len(body[i]) > len(pad) else pad
        else:
            body.append(line)
    return "\n".join(body)
