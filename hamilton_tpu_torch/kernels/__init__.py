"""The port's hand-written CUDA kernels: nvcc build, ctypes binding, launch.

Every ``csrc/<name>.cu`` is compiled the same way, at first use, into
``hamilton_tpu_torch/_build/`` as a shared library with a plain C interface,
named by a hash of the source and the flags so that an edited source is
rebuilt.  :func:`build_all` starts one nvcc per source at once.  Only the
machine with the card has ``nvcc``; importing this module builds nothing.  A
failed build raises with nvcc's stderr.

Each launch function counts its launches in ``<function>.launches`` (a plain
integer: :func:`reset_launches` sets them all to 0 before a run,
:func:`launch_counts` reads them after) so that a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

__all__ = [
    "KernelBuild",
    "NVCC_FLAGS",
    "SOURCES",
    "build",
    "build_all",
    "fused_step_launch",
    "fma_probe_launch",
    "sin_probe_launch",
    "add_one_launch",
    "spd_solve_launch",
    "cholesky_launch",
    "cho_solve_launch",
    "spd_solve_jac_launch",
    "cholesky_jac_launch",
    "LAUNCHERS",
    "reset_launches",
    "launch_counts",
]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"

#: No --use_fast_math: it would reassociate the fused step's Kahan
#: compensation away, replace sinf/cosf by approximations, and make square
#: roots and divisions inexact.  -Xptxas -v reports registers and spills per
#: instantiation.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class KernelBuild:
    """A built kernel library: its path, the seconds the build took in this
    process (0.0 when an earlier build was reused) and nvcc's report."""

    path: Path
    seconds: float
    log: str


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the kernels "
        "are built from source on the machine with the card"
    )


def _paths(name: str):
    if name not in SOURCES:
        raise ValueError(f"no kernel source {name!r}; sources: {SOURCES}")
    src = _CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    stem = f"lib{name}-{key.hexdigest()[:16]}"
    return src, _BUILD_DIR / f"{stem}.so", _BUILD_DIR / f"{stem}.log"


_BUILT: Dict[str, KernelBuild] = {}


def _start(name: str) -> Optional[tuple]:
    """Reuse a finished build of ``name``, or start nvcc on it:
    ``None`` once built, else what :func:`_finish` waits on."""
    if name in _BUILT:
        return None
    src, lib, log = _paths(name)
    if lib.exists() and log.exists():
        _BUILT[name] = KernelBuild(lib, 0.0, log.read_text())
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, cmd, tmp, lib, log, time.perf_counter()


def _finish(name: str, started: Optional[tuple]) -> KernelBuild:
    if started is None:
        return _BUILT[name]
    proc, cmd, tmp, lib, log, t0 = started
    out, err = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building csrc/{name}.cu:\n"
            f"{' '.join(cmd)}\n{err}"
        )
    report = out + err
    log.write_text(report)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    _BUILT[name] = KernelBuild(lib, seconds, report)
    return _BUILT[name]


def build(name: str) -> KernelBuild:
    """Build (or reuse) ``csrc/<name>.cu``; raises on nvcc failure."""
    return _finish(name, _start(name))


def build_all() -> Dict[str, KernelBuild]:
    """Build every source at once, one nvcc process each; raises on the
    first failure after all have ended."""
    started = {name: _start(name) for name in SOURCES}
    results, failures = {}, []
    for name, st in started.items():
        try:
            results[name] = _finish(name, st)
        except RuntimeError as e:
            failures.append(str(e))
    if failures:
        raise RuntimeError("\n\n".join(failures))
    return results


_VP, _INT, _LL, _DBL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double

#: The C entry points of each ``csrc/<name>.cu`` and their argument types
#: (pointers and the stream as void*, so ctypes never cuts them to 32 bits).
_SIGNATURES = {
    "fused_step": {
        "hamilton_fused_step": [_INT, _INT, _INT, _VP, _VP, _VP, _LL, _DBL, _INT,
                                _INT, _INT, _INT, ctypes.POINTER(_DBL), _VP],
    },
    "roofline_probes": {
        "hamilton_fma_probe": [_INT, _VP, _VP, _LL, _INT, _INT, _VP],
        "hamilton_sin_probe": [_INT, _VP, _VP, _LL, _INT, _INT, _VP],
        "hamilton_add_one": [_VP, _VP, _LL, _INT, _VP],
    },
    "batched_spd": {
        "hamilton_spd_factor": [_INT, _INT, _VP, _VP, _LL, _INT, _INT, _VP],
        "hamilton_spd_substitute": [_INT, _VP, _VP, _VP, _LL, _INT, _VP],
        "hamilton_spd_solve": [_INT, _INT, _VP, _VP, _VP, _LL, _INT, _INT, _VP],
    },
}

#: The sources, by name: ``csrc/<name>.cu`` builds ``lib<name>-<hash>.so``.
SOURCES = tuple(sorted(_SIGNATURES))


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(name).path))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hamilton_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hamilton_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _call(name: str, fn: str, what: str, *args) -> None:
    """Call a C entry point; raise unless it launched (0)."""
    lib = _library(name)
    code = getattr(lib, fn)(*args)
    if code == -1:
        raise ValueError(f"{what} kernel not instantiated for these arguments: {args}")
    if code == -2:
        raise ValueError(f"{what} kernel rejected its arguments: {args}")
    if code != 0:
        msg = lib.hamilton_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code}: {msg}")


@functools.lru_cache(maxsize=None)
def _weights(weights: tuple):
    """The composition weights as a C array, made once per composition (the
    cache keeps it alive): one pointer argument on every launch."""
    return (_DBL * len(weights))(*weights)


def fused_step_launch(
    *,
    dtype_code: int,
    n: int,
    semiseparable: bool,
    compensated: bool,
    per_member: bool,
    coef: int,
    state_in: int,
    state_out: int,
    batch: int,
    dt: float,
    iters_p: int,
    iters_q: int,
    steps_per_call: int,
    weights: tuple,
    stream: int,
) -> None:
    """Launch the fused-step kernel (K1) on raw device pointers
    (``data_ptr()`` ints) and a stream handle; the caller has validated every
    argument (``ops.fused_step.fused_step_kernel``).  ``coef`` is the shared
    table, or the ``(L, B)`` per-member one when ``per_member``; ``weights``
    is the tuple of 1 to 5 composition weights.  Raises if the launch
    fails."""
    flags = int(semiseparable) | int(compensated) << 1 | int(per_member) << 2
    _call("fused_step", "hamilton_fused_step", "fused-step", dtype_code, n, flags, coef,
          state_in, state_out, batch, dt, iters_p, iters_q, steps_per_call, len(weights),
          _weights(weights), stream)
    fused_step_launch.launches += 1


# The batched tiny-SPD entries (K2a-K2e, csrc/batched_spd.cu).  Each takes
# member-major contiguous operands that the caller has validated
# (ops.batched_spd): K and L (B, n, n), sqrt(M) J (B, m, n), b and x (B, n).


def spd_solve_launch(*, dtype_code, k, b, x, batch, n, stream) -> None:
    """K2a: factor K and solve ``K x = b``."""
    _call("batched_spd", "hamilton_spd_solve", "spd_solve", dtype_code, 0, k, b, x,
          batch, n, 0, stream)
    spd_solve_launch.launches += 1


def cholesky_launch(*, dtype_code, k, low, batch, n, stream) -> None:
    """K2b: the lower Cholesky factor of K."""
    _call("batched_spd", "hamilton_spd_factor", "cholesky", dtype_code, 0, k, low,
          batch, n, 0, stream)
    cholesky_launch.launches += 1


def cho_solve_launch(*, dtype_code, low, b, x, batch, n, stream) -> None:
    """K2c: solve ``L Lᵀ x = b`` from a factor."""
    _call("batched_spd", "hamilton_spd_substitute", "cho_solve", dtype_code, low, b, x,
          batch, n, stream)
    cho_solve_launch.launches += 1


def spd_solve_jac_launch(*, dtype_code, js, b, x, batch, n, m, stream) -> None:
    """K2d: form ``K = (√M J)ᵀ(√M J)``, factor it and solve ``K x = b``."""
    _call("batched_spd", "hamilton_spd_solve", "spd_solve_jac", dtype_code, 1, js, b, x,
          batch, n, m, stream)
    spd_solve_jac_launch.launches += 1


def cholesky_jac_launch(*, dtype_code, js, low, batch, n, m, stream) -> None:
    """K2e: form K from √M·J and factor it."""
    _call("batched_spd", "hamilton_spd_factor", "cholesky_jac", dtype_code, 1, js, low,
          batch, n, m, stream)
    cholesky_jac_launch.launches += 1


# The roofline probes (K3a-K3c, csrc/roofline_probes.cu) on float32 buffers
# that the caller has validated (utils.roofline).


def fma_probe_launch(*, x, out, elements, chains, reps, block, stream) -> None:
    """K3a: ``reps`` dependent ``x·1.0000001 + 1.1920929e-07`` FMAs on each
    element, ``chains`` independent elements per thread."""
    _call("roofline_probes", "hamilton_fma_probe", "fma_probe", chains, x, out,
          elements, reps, block, stream)
    fma_probe_launch.launches += 1


def sin_probe_launch(*, x, out, elements, chains, reps, block, stream) -> None:
    """K3b: ``reps`` dependent ``sinf(x) + 1.1920929e-07`` on each element."""
    _call("roofline_probes", "hamilton_sin_probe", "sin_probe", chains, x, out,
          elements, reps, block, stream)
    sin_probe_launch.launches += 1


def add_one_launch(*, a, out, elements, blocks, stream) -> None:
    """K3c: ``out = a + 1``, grid-strided with 16-byte loads and stores."""
    _call("roofline_probes", "hamilton_add_one", "add_one", a, out, elements,
          blocks, stream)
    add_one_launch.launches += 1


#: Every launch function, by the name the counts are reported under.
LAUNCHERS = {
    "fused_step": fused_step_launch,
    "spd_solve": spd_solve_launch,
    "cholesky": cholesky_launch,
    "cho_solve": cho_solve_launch,
    "spd_solve_jac": spd_solve_jac_launch,
    "cholesky_jac": cholesky_jac_launch,
    "fma_probe": fma_probe_launch,
    "sin_probe": sin_probe_launch,
    "add_one": add_one_launch,
}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for fn in LAUNCHERS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """The launch counts since the last :func:`reset_launches`."""
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


reset_launches()
