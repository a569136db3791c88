"""Numerical-health sentinels: NaN guards and energy-blowup detection.

PyTorch counterpart of :mod:`hamilton_tpu.utils.diagnostics`.  Long
horizons can go non-finite without notice (too large a dt, a singular
coordinate map such as the two-body ``r → 0``); these helpers catch it
without a host read inside the loop.

Error semantics: the reference carries a ``checkify`` error as a value and
raises on the host after the computation.  Here :func:`nan_guard` inside a
:func:`checked` function records a flag on the state's device (a running
"first failing guard" index: no host read, so nothing waits for the card),
and :func:`checked` reads it once, after the function returns, raising
:class:`CheckError` with the reference's message for the first guard that
failed.  Outside :func:`checked` a guard raises at once (a host read), as
the reference's eager call does.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Dict, List

import torch
from torch.overrides import TorchFunctionMode

from hamilton_tpu_torch.mechanics import hamiltonian
from hamilton_tpu_torch.state import Phase
from hamilton_tpu_torch.system import System

__all__ = ["check_finite_phase", "nan_guard", "checked", "energy_sentinel"]

#: The error categories of :func:`checked`'s ``errors=`` (``checkify``'s):
#: the user's checks (:func:`nan_guard`), NaN outputs of floating-point ops,
#: divisions by zero; ``float_checks`` the two float ones, as the reference's.
user_checks = frozenset({"user"})
nan_checks = frozenset({"nan"})
div_checks = frozenset({"div"})
float_checks = nan_checks | div_checks
all_checks = user_checks | float_checks


class CheckError(RuntimeError):
    """A failed check, raised on the host after the checked function."""


class _Frame:
    """The checks of one :func:`checked` call: the messages in the order
    they were recorded, and per device the index of the first that failed
    (-1 while none has), kept on that device."""

    def __init__(self, errors):
        self.errors = frozenset(errors)
        self.messages: List[str] = []
        self.first: Dict[torch.device, torch.Tensor] = {}

    def record(self, ok: torch.Tensor, message: str) -> None:
        index = len(self.messages)
        self.messages.append(message)
        first = self.first.get(ok.device)
        if first is None:
            first = torch.full((), -1, dtype=torch.int64, device=ok.device)
        self.first[ok.device] = torch.where(ok | (first >= 0), first, index)

    def throw(self) -> None:
        failed = [int(first) for first in self.first.values()]  # the one host read
        failed = [i for i in failed if i >= 0]
        if failed:
            raise CheckError(self.messages[min(failed)])


_ACTIVE = threading.local()


def _frames() -> List[_Frame]:
    if not hasattr(_ACTIVE, "frames"):
        _ACTIVE.frames = []
    return _ACTIVE.frames


def check_finite_phase(phase: Phase) -> torch.Tensor:
    """0-d bool tensor: every member of (batched) phase is finite."""
    return torch.logical_and(torch.isfinite(phase.q).all(), torch.isfinite(phase.p).all())


def nan_guard(phase: Phase, where: str = "step") -> Phase:
    """Check that the state is finite; pass it through.  Insertable in any
    hot loop: inside :func:`checked` it records a flag on the device and
    reads nothing back; outside it raises :class:`CheckError` at once."""
    message = f"non-finite state detected at {where}"
    frames = _frames()
    if not frames:
        if not bool(check_finite_phase(phase)):
            raise CheckError(message)
    elif "user" in frames[-1].errors:
        frames[-1].record(check_finite_phase(phase), message)
    return phase


_DIVISIONS = {"div", "div_", "true_divide", "true_divide_", "truediv", "rtruediv", "itruediv",
              "floor_divide", "floor_divide_", "floordiv", "rfloordiv", "remainder", "fmod",
              "reciprocal", "reciprocal_"}


class _FloatChecks(TorchFunctionMode):
    """Every floating-point op of the checked function checked as
    ``checkify``'s float checks check it: a NaN in an output ("nan generated
    by primitive: <op>."), a division by zero ("division by zero")."""

    def __init__(self, frame: _Frame):
        super().__init__()
        self.frame = frame

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", str(func)).strip("_")
        frame = self.frame
        if "div" in frame.errors and name in _DIVISIONS:
            divisor = args[0] if name in ("reciprocal", "reciprocal_", "rtruediv",
                                          "rfloordiv") else (args[1] if len(args) > 1 else None)
            if isinstance(divisor, torch.Tensor):
                frame.record((divisor != 0).all(), "division by zero")
            elif isinstance(divisor, (int, float)) and divisor == 0:
                frame.record(torch.zeros((), dtype=torch.bool), "division by zero")
        if "nan" in frame.errors:
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    frame.record(~torch.isnan(t).any(),
                                 f"nan generated by primitive: {name.rstrip('_')}.")
        return out


def checked(fn: Callable, *, errors=user_checks) -> Callable:
    """Wrap ``fn`` (which may contain :func:`nan_guard` calls) so that the
    recorded checks are read once after it returns and the first failure
    raises :class:`CheckError` on the host.

    ``errors=float_checks`` checks every floating-point op of ``fn`` for a
    NaN output or a division by zero instead (heavier; debugging mode);
    ``all_checks`` does both."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        frame = _Frame(errors)
        frames = _frames()
        frames.append(frame)
        try:
            if frame.errors & float_checks:
                with _FloatChecks(frame):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
        finally:
            frames.pop()
        frame.throw()
        return out

    return run


def energy_sentinel(
    system: System, phase: Phase, h0: torch.Tensor, *, tol: float = 1e3
) -> torch.Tensor:
    """0-d bool tensor: |H − H₀| within ``tol·max(|H₀|, 1)`` for every
    member — a cheap blowup detector for fixed-step runs with too large a
    dt.  ``hamiltonian`` maps the members itself."""
    h = hamiltonian(system, phase)
    return torch.all(torch.abs(h - h0) <= tol * torch.clamp(torch.abs(h0), min=1.0))
