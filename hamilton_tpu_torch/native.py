"""ctypes bindings to the repository's native C++ ODE engine
(``native/hamode.cpp``): the port's own copy of :mod:`hamilton_tpu.native`,
under its names and signatures, numpy in and numpy out.

The engine is a from-scratch C++ RKF45 with GSL's evolve/control laws.  It
serves as

* an **independent parity oracle** for the port's adaptive driver
  (``integrators/adaptive.py``): the same control laws, implemented
  separately, so agreement is strong evidence that both match GSL, and its
  closed-form chain (``chain_evolve``) checks the AD-derived dynamics;
* a native CPU path for single-trajectory stepping, the host-CPU baseline
  beside the card.

The library is built with the Makefile's own rule at first use into
``hamilton_tpu_torch/_build/native/`` (``make -C native BUILD=<dir>``): a
build directory of its own, never ``native/build/`` where the JAX package's
binding builds the same source, so that the two never race on one ``make``
target.  Each build runs in a directory of its own and the finished library
is moved into place in one step, so a concurrent process never loads a
partial file.  Its name carries a hash of the source and the Makefile: an
edited engine is rebuilt.  ``make`` runs with the Makefile's own compiler
(``g++``), not a ``CXX`` from the environment: the engine needs OpenMP
(``-fopenmp``), and a compiler set there for other builds may lack it (one
without ``libgomp`` fails on that flag).  A failed build's report is kept
in ``_build_error``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np

__all__ = [
    "available",
    "load",
    "rkf45_evolve_times",
    "double_pendulum_evolve",
    "double_pendulum_fixed_steps",
    "chain_evolve",
    "chain_ensemble_fixed_steps",
    "GSL_EPS_DEFAULT",
]

GSL_EPS_DEFAULT = 1.49012e-08  # reference Hamilton.hs:448

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_BUILD_DIR = Path(__file__).resolve().parent / "_build" / "native"

_RHS_FN = ctypes.CFUNCTYPE(
    None,
    ctypes.POINTER(ctypes.c_double),
    ctypes.POINTER(ctypes.c_double),
    ctypes.c_int,
    ctypes.c_void_p,
)


class _Stats(ctypes.Structure):
    _fields_ = [
        ("n_steps", ctypes.c_int64),
        ("n_rejected", ctypes.c_int64),
        ("h_final", ctypes.c_double),
    ]


_lib = None
_build_error = ""


def _so_path() -> Path:
    """The library of this engine source and Makefile."""
    key = hashlib.sha256((_NATIVE_DIR / "hamode.cpp").read_bytes()
                         + (_NATIVE_DIR / "Makefile").read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"libhamode-{key}.so"


def _build(so: Path) -> bool:
    """Run the Makefile into a fresh directory beside ``so``, then move its
    library to ``so``; whether ``so`` exists after (else the reason in
    ``_build_error``)."""
    global _build_error
    env = {k: v for k, v in os.environ.items() if k != "CXX"}
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        where = Path(tempfile.mkdtemp(prefix="make-", dir=_BUILD_DIR))
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR), f"BUILD={where}"], check=True,
                           capture_output=True, text=True, timeout=120, env=env)
            os.replace(where / "libhamode.so", so)
        finally:
            shutil.rmtree(where, ignore_errors=True)
        return so.exists()
    except subprocess.CalledProcessError as e:
        _build_error = e.stdout + e.stderr
    except (subprocess.SubprocessError, OSError) as e:
        _build_error = repr(e)
    return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    so = _so_path()
    if not so.exists() and not _build(so):
        return None
    lib = ctypes.CDLL(str(so))
    lib.ham_rkf45_evolve_times.restype = ctypes.c_int
    lib.ham_rkf45_evolve_times.argtypes = [
        _RHS_FN, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.POINTER(_Stats),
    ]
    lib.ham_double_pendulum_evolve.restype = ctypes.c_int
    lib.ham_double_pendulum_evolve.argtypes = [
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(_Stats),
    ]
    lib.ham_double_pendulum_fixed_steps.restype = ctypes.c_int
    lib.ham_double_pendulum_fixed_steps.argtypes = [
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.ham_chain_evolve.restype = ctypes.c_int
    lib.ham_chain_evolve.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(_Stats),
    ]
    lib.ham_chain_ensemble_fixed_steps.restype = ctypes.c_int
    lib.ham_chain_ensemble_fixed_steps.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _loaded() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("native hamode library unavailable (g++/make failed?)")
    return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _stats(stats: _Stats) -> dict:
    return {"n_steps": stats.n_steps, "n_rejected": stats.n_rejected,
            "h_final": stats.h_final}


def rkf45_evolve_times(
    rhs: Callable[[np.ndarray], np.ndarray],
    y0: np.ndarray,
    ts: np.ndarray,
    *,
    eps_abs: float = GSL_EPS_DEFAULT,
    eps_rel: float = GSL_EPS_DEFAULT,
    h0: float = -1.0,
) -> Tuple[np.ndarray, dict]:
    """Evolve an arbitrary Python RHS with the native engine.

    ``rhs(y) -> dydt`` (float64 numpy in and out) is called back per RK
    stage, the C-to-caller callback structure of the reference's GSL
    integration; a right-hand side on the card copies ``y`` there and its
    result back each stage.  Returns ``(out[n_ts, dim], stats)``.
    """
    lib = _loaded()
    y0 = np.ascontiguousarray(y0, dtype=np.float64)
    ts = np.ascontiguousarray(ts, dtype=np.float64)
    dim = y0.shape[0]
    out = np.empty((ts.shape[0], dim), dtype=np.float64)

    @_RHS_FN
    def cb(y_ptr, dydt_ptr, d, _user):
        y = np.ctypeslib.as_array(y_ptr, shape=(d,))
        dydt = np.ascontiguousarray(rhs(y), dtype=np.float64)
        ctypes.memmove(dydt_ptr, dydt.ctypes.data, d * 8)

    stats = _Stats()
    rc = lib.ham_rkf45_evolve_times(
        cb, None, dim, _dptr(ts), ts.shape[0], eps_abs, eps_rel, h0,
        _dptr(y0), _dptr(out), 10_000_000, ctypes.byref(stats),
    )
    if rc != 0:
        raise RuntimeError(f"native rkf45 failed with code {rc}")
    return out, _stats(stats)


def double_pendulum_evolve(
    m1: float,
    m2: float,
    y0: np.ndarray,
    ts: np.ndarray,
    *,
    eps_abs: float = GSL_EPS_DEFAULT,
    eps_rel: float = GSL_EPS_DEFAULT,
    h0: float = -1.0,
) -> Tuple[np.ndarray, dict]:
    """Native analytic double pendulum (the reference's baseline
    configuration): no Python in the hot loop."""
    lib = _loaded()
    y0 = np.ascontiguousarray(y0, dtype=np.float64)
    ts = np.ascontiguousarray(ts, dtype=np.float64)
    out = np.empty((ts.shape[0], 4), dtype=np.float64)
    stats = _Stats()
    rc = lib.ham_double_pendulum_evolve(
        m1, m2, _dptr(ts), ts.shape[0], eps_abs, eps_rel, h0, _dptr(y0),
        _dptr(out), ctypes.byref(stats),
    )
    if rc != 0:
        raise RuntimeError(f"native double-pendulum evolve failed: {rc}")
    return out, _stats(stats)


def chain_evolve(
    masses,
    y0: np.ndarray,
    ts: np.ndarray,
    *,
    link_length: float = 1.0,
    gravity: float = 5.0,
    eps_abs: float = GSL_EPS_DEFAULT,
    eps_rel: float = GSL_EPS_DEFAULT,
    h0: float = -1.0,
) -> Tuple[np.ndarray, dict]:
    """Adaptive evolve of the analytic n-link chain (closed-form ``K``,
    ``∂T/∂q``, ``∇U``): an independent oracle for the AD-derived
    ``models.chain`` dynamics.  ``y0`` is ``[q, p]`` of length 2n."""
    lib = _loaded()
    masses = np.ascontiguousarray(masses, dtype=np.float64)
    n = masses.shape[0]
    y0 = np.ascontiguousarray(y0, dtype=np.float64)
    ts = np.ascontiguousarray(ts, dtype=np.float64)
    out = np.empty((ts.shape[0], 2 * n), dtype=np.float64)
    stats = _Stats()
    rc = lib.ham_chain_evolve(
        n, _dptr(masses), link_length, gravity, _dptr(ts), ts.shape[0],
        eps_abs, eps_rel, h0, _dptr(y0), _dptr(out), ctypes.byref(stats),
    )
    if rc != 0:
        raise RuntimeError(f"native chain evolve failed: {rc}")
    return out, _stats(stats)


def chain_ensemble_fixed_steps(
    masses,
    states: np.ndarray,
    h: float,
    n_steps: int,
    *,
    link_length: float = 1.0,
    gravity: float = 5.0,
) -> np.ndarray:
    """Native multi-core (OpenMP) ensemble stepping: ``states`` is
    ``(members, 2n)``; returns them advanced by ``n_steps`` fixed-h RKF45
    steps a member, the host-CPU counterpart of the ensemble path."""
    lib = _loaded()
    masses = np.ascontiguousarray(masses, dtype=np.float64)
    out = np.ascontiguousarray(states, dtype=np.float64).copy()
    rc = lib.ham_chain_ensemble_fixed_steps(
        masses.shape[0], _dptr(masses), link_length, gravity, h,
        n_steps, out.shape[0], _dptr(out),
    )
    if rc != 0:
        raise RuntimeError(f"native chain ensemble failed: {rc}")
    return out


def double_pendulum_fixed_steps(
    m1: float, m2: float, h: float, n_steps: int, y0: np.ndarray
) -> np.ndarray:
    """Fixed-h RKF45 stepping for throughput baselining (no error control)."""
    lib = _loaded()
    y = np.ascontiguousarray(y0, dtype=np.float64).copy()
    rc = lib.ham_double_pendulum_fixed_steps(m1, m2, h, n_steps, _dptr(y))
    if rc != 0:
        raise RuntimeError(f"native fixed steps failed: {rc}")
    return y
