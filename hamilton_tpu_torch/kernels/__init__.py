"""The port's hand-written CUDA kernels: nvcc build, ctypes binding, launch.

``csrc/fused_step.cu`` is compiled at first use into
``hamilton_tpu_torch/_build/`` as a shared library with a plain C entry
point, named by a hash of the source and the flags so that an edited source
is rebuilt.  Only the machine with the card has ``nvcc``; importing this
module builds nothing.  A failed build raises with nvcc's stderr.

:func:`fused_step_launch` counts its launches in ``fused_step_launch.launches``
(a plain integer: set it to 0 before a run, read it after) so that a run can
show that its main path went through the kernel.
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

__all__ = ["KernelBuild", "build_fused_step", "fused_step_launch", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "fused_step.cu"
_BUILD_DIR = _PKG / "_build"

#: No --use_fast_math: it would reassociate the Kahan compensation away and
#: replace sinf/cosf by approximations.  -Xptxas -v reports registers and
#: spills per instantiation.
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
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the fused-step "
        "kernel is built from source on the machine with the card"
    )


@functools.lru_cache(maxsize=None)
def build_fused_step() -> KernelBuild:
    """Build (or reuse) the fused-step library; raises on nvcc failure."""
    key = hashlib.sha256(_SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    stem = f"libfused_step-{key.hexdigest()[:16]}"
    lib, log = _BUILD_DIR / f"{stem}.so", _BUILD_DIR / f"{stem}.log"
    if lib.exists() and log.exists():
        return KernelBuild(lib, 0.0, log.read_text())
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _BUILD_DIR / f"{stem}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {_SOURCE.name}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return KernelBuild(lib, seconds, report)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_fused_step().path))
    lib.hamilton_fused_step.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.hamilton_fused_step.restype = ctypes.c_int
    lib.hamilton_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hamilton_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_step_launch(
    *,
    dtype_code: int,
    n: int,
    semiseparable: bool,
    compensated: bool,
    coef: int,
    state_in: int,
    state_out: int,
    batch: int,
    dt: float,
    iters_p: int,
    iters_q: int,
    steps_per_call: int,
    stream: int,
) -> None:
    """Launch the fused-step kernel on raw device pointers (``data_ptr()``
    ints) and a stream handle; the caller has validated every argument
    (``ops.fused_step.fused_step_kernel``).  Raises if the launch fails."""
    lib = _library()
    code = lib.hamilton_fused_step(
        dtype_code, n, int(semiseparable), int(compensated), coef, state_in,
        state_out, batch, dt, iters_p, iters_q, steps_per_call, stream,
    )
    if code == -1:
        raise ValueError(
            f"fused-step kernel not instantiated for dtype code {dtype_code}, "
            f"n={n}, semiseparable={semiseparable}"
        )
    if code == -2:
        raise ValueError("fused-step kernel rejected its arguments")
    if code != 0:
        msg = lib.hamilton_cuda_error_string(code).decode()
        raise RuntimeError(f"fused-step kernel launch failed: CUDA error {code}: {msg}")
    fused_step_launch.launches += 1


fused_step_launch.launches = 0
