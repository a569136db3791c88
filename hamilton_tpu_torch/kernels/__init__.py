"""The port's hand-written CUDA kernels: nvcc build, ctypes binding, launch.

Every ``csrc/<name>.cu`` is compiled the same way, at first use, into
``hamilton_tpu_torch/_build/`` as a shared library with a plain C interface,
named by a hash of the source, the shared headers ``csrc/*.cuh`` and the
flags so that an edited source or header is rebuilt.  :func:`build_all`
starts one nvcc per source at once, or one per part of a source that
:data:`PARTS` splits.  Only the machine with the card has
``nvcc``; importing this module builds nothing.  A failed build raises with
nvcc's stderr.

``csrc/user_family_step.cu`` is a template: it includes the header that
``ops.fused_codegen`` generates from a family's forms, and
:func:`build_user_family` compiles it at first use for each header, named
by a hash of the header, the template, the shared headers and the flags
(a family's parameter values are not in the header, so they rebuild
nothing).

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
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "KernelBuild",
    "NVCC_FLAGS",
    "SOURCE_FLAGS",
    "SOURCES",
    "PARTS",
    "build",
    "build_all",
    "build_user_family",
    "fused_step_launch",
    "chain_variants_launch",
    "linv_layout",
    "family_step_launch",
    "user_family_launch",
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

#: Flags of one source beside :data:`NVCC_FLAGS`.  ``family_step`` and
#: ``chain_variants``: no FMA contraction, so the kernel rounds each product
#: and sum as its plain version does.  The families' warm-start carry
#: ``vdot_est = (v1 − v0)/h`` is a difference of nearly equal velocities (it
#: vanishes where K is constant), so an FMA's other rounding of v, an ulp,
#: would show at the scale of ``vdot_est`` itself; the chain's L⁻¹ solves go
#: through the explicit inverse factor, whose entries grow with cond(K), so
#: an ulp there shows at cond(K) times it.
SOURCE_FLAGS = {"family_step": ("-fmad=false",), "chain_variants": ("-fmad=false",),
                "user_family_step": ("-fmad=false",)}

#: Sources built as several libraries at once: name → (number of parts, the
#: part that holds a launch's ``(dtype_code, code)``).  Part ``i`` is the
#: source compiled with ``-DHAMILTON_PART=i`` and holds that share of its
#: dispatch: one part per variant and dtype, so the instantiations compile
#: on as many cores.  As one nvcc each, ``chain_variants``' 80 took 560 s
#: and ``fused_step``'s 48 up to 311 s on the card's machine (PERF.md §6).
#: ``fused_step``'s code is n: 20 and 5 semiseparable, 2 dense.
PARTS: Dict[str, Tuple[int, Callable[[int, int], int]]] = {
    "fused_step": (6, lambda dtype_code, n: 2 * {20: 0, 5: 1, 2: 2}.get(n, 3) + dtype_code),
    "chain_variants": (10, lambda dtype_code, code: 2 * code + dtype_code),
}

@dataclass(frozen=True)
class KernelBuild:
    """A built kernel source: its libraries (one, or one per part), the
    seconds its build took in this process (its slowest part's; 0.0 when
    earlier builds were reused), each part's, and nvcc's report (every
    part's)."""

    paths: Tuple[Path, ...]
    seconds: float
    log: str
    part_seconds: Tuple[float, ...]


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


def _units(name: str):
    """The build units of a source: ``(name, None)``, or one per part."""
    if name not in SOURCES:
        raise ValueError(f"no kernel source {name!r}; sources: {SOURCES}")
    if name not in PARTS:
        return [(name, None)]
    return [(name, part) for part in range(PARTS[name][0])]


def _paths(name: str, part: Optional[int]):
    src = _CSRC / f"{name}.cu"
    # the shared headers are part of every source's key: an edited header
    # rebuilds what includes it
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    flags = _flags(name, part)
    key = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode())
    stem = f"lib{name}{'' if part is None else f'-p{part}'}-{key.hexdigest()[:16]}"
    return src, _BUILD_DIR / f"{stem}.so", _BUILD_DIR / f"{stem}.log"


def _flags(name: str, part: Optional[int]):
    part_flag = () if part is None else (f"-DHAMILTON_PART={part}",)
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ()) + part_flag


#: Finished builds by unit, ``(name, part)``: ``(library, seconds, report)``.
_BUILT: Dict[tuple, tuple] = {}


#: nvcc runs in this process (a reused build runs none).
NVCC_RUNS = {"count": 0}


def _compile(src: Path, lib: Path, log: Path, flags, what: str) -> tuple:
    """Run nvcc on ``src`` into ``lib`` (atomically: a concurrent build
    never loads a partial file), keep its report in ``log``;
    ``(library, seconds, report)``.  Raises with nvcc's stderr."""
    NVCC_RUNS["count"] += 1
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"{lib.stem}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {what}:\n"
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, lib)
    return lib, seconds, report


def _build_unit(unit: tuple) -> tuple:
    """Reuse a finished build of ``unit`` or run nvcc on it (it waits for
    nvcc, so the seconds are this unit's own); raises on nvcc failure."""
    if unit in _BUILT:
        return _BUILT[unit]
    name, part = unit
    src, lib, log = _paths(name, part)
    if lib.exists() and log.exists():
        _BUILT[unit] = (lib, 0.0, log.read_text())
        return _BUILT[unit]
    _BUILT[unit] = _compile(src, lib, log, _flags(name, part), f"csrc/{name}.cu")
    return _BUILT[unit]


def _build_units(units) -> list:
    """Build units at once, one nvcc process each; raises on the first
    failure after all have ended."""
    with ThreadPoolExecutor(max_workers=max(len(units), 1)) as pool:
        futures = [pool.submit(_build_unit, unit) for unit in units]
    failures = [str(f.exception()) for f in futures if f.exception() is not None]
    if failures:
        raise RuntimeError("\n\n".join(failures))
    return [f.result() for f in futures]


def _merged(built) -> KernelBuild:
    return KernelBuild(tuple(b[0] for b in built), max(b[1] for b in built),
                       "".join(b[2] for b in built), tuple(b[1] for b in built))


def build(name: str, parts: Optional[Tuple[int, ...]] = None) -> KernelBuild:
    """Build (or reuse) ``csrc/<name>.cu``, every part at once, or only
    ``parts`` of a source that :data:`PARTS` splits; raises on nvcc
    failure."""
    units = _units(name)
    if parts is not None:
        if name not in PARTS or not set(parts) <= {part for _, part in units}:
            raise ValueError(f"{name}: no parts {parts}")
        units = [(name, part) for part in parts]
    return _merged(_build_units(units))


def build_all() -> Dict[str, KernelBuild]:
    """Build every source (every part) at once, one nvcc process each;
    raises on the first failure after all have ended."""
    units = [unit for name in SOURCES for unit in _units(name)]
    built = dict(zip(units, _build_units(units)))
    return {name: _merged([built[u] for u in _units(name)]) for name in SOURCES}


#: The template of the generated families' kernel.
USER_FAMILY_TEMPLATE = _CSRC / "user_family_step.cu"


def _user_family_paths(header: str):
    """The build directory of a generated header: named by a sha256 of the
    header, the template, the shared headers and the flags."""
    flags = NVCC_FLAGS + SOURCE_FLAGS["user_family_step"]
    cuh = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    key = hashlib.sha256(header.encode() + USER_FAMILY_TEMPLATE.read_bytes() + cuh
                         + " ".join(flags).encode()).hexdigest()[:16]
    return key, _BUILD_DIR / f"user_family-{key}", flags


def build_user_family(header: str) -> Tuple[str, KernelBuild]:
    """Build (or reuse) ``csrc/user_family_step.cu`` around a generated
    header (``ops.fused_codegen``): ``(key, build)``, the key naming the
    library for :func:`user_family_launch`.  The header is written
    atomically into its own directory of ``_build/``, beside the library and
    nvcc's ``-Xptxas -v`` report.  Raises with nvcc's report on failure."""
    key, where, flags = _user_family_paths(header)
    unit = ("user_family", key)
    if unit not in _BUILT:
        lib, log = where / "libuser_family.so", where / "build.log"
        if lib.exists() and log.exists():
            _BUILT[unit] = (lib, 0.0, log.read_text())
        else:
            where.mkdir(parents=True, exist_ok=True)
            tmp = where / f"user_family.h.{os.getpid()}.tmp"
            tmp.write_text(header)
            os.replace(tmp, where / "user_family.h")
            _BUILT[unit] = _compile(USER_FAMILY_TEMPLATE, lib, log, flags + ("-I", str(where)),
                                    f"csrc/user_family_step.cu for {where / 'user_family.h'}")
    lib, seconds, report = _BUILT[unit]
    return key, KernelBuild((lib,), seconds, report, (seconds,))


_VP, _INT, _LL, _DBL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double

#: The C entry points of each ``csrc/<name>.cu`` and their argument types
#: (pointers and the stream as void*, so ctypes never cuts them to 32 bits).
_SIGNATURES = {
    "fused_step": {
        "hamilton_fused_step": [_INT, _INT, _INT, _VP, _VP, _VP, _LL, _DBL, _INT,
                                _INT, _INT, _INT, ctypes.POINTER(_DBL), _VP],
    },
    "chain_variants": {
        "hamilton_chain_variant_step": [_INT, _INT, _INT, _VP, _VP, _VP, _LL, _DBL, _INT,
                                        _INT, _INT, _INT, ctypes.POINTER(_DBL), _VP],
        "hamilton_linv_layout": [_INT, _INT, _INT, ctypes.POINTER(_INT)],
    },
    "family_step": {
        "hamilton_family_step": [_INT, _INT, _INT, _VP, _VP, _VP, _LL, _DBL, _INT,
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
def _library(name: str, part: Optional[int] = None) -> ctypes.CDLL:
    """The loaded library of a source (of one part of it), built at first
    use."""
    if name not in SOURCES:
        raise ValueError(f"no kernel source {name!r}; sources: {SOURCES}")
    n_parts = PARTS[name][0] if name in PARTS else None
    if (part is None) != (n_parts is None) or not (part is None or 0 <= part < n_parts):
        raise ValueError(f"{name}: no part {part} (parts: {n_parts})")
    lib = ctypes.CDLL(str(_build_unit((name, part))[0]))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hamilton_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hamilton_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _user_library(key: str) -> ctypes.CDLL:
    """The loaded library of a generated family, built by
    :func:`build_user_family` in this process."""
    lib = ctypes.CDLL(str(_BUILT[("user_family", key)][0]))
    lib.hamilton_user_family_step.argtypes = _SIGNATURES["family_step"]["hamilton_family_step"]
    lib.hamilton_user_family_step.restype = ctypes.c_int
    lib.hamilton_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hamilton_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _call(name: str, fn: str, what: str, *args, part=None) -> None:
    """Call a C entry point (of one part of a source built in parts, or of
    the generated family ``part`` names); raise unless it launched (0)."""
    lib = _user_library(part) if name == "user_family" else _library(name, part)
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


def _k1_launcher(source: str, entry: str, what: str):
    """A launch function for one of K1's libraries: ``source`` is
    ``csrc/<source>.cu``, ``entry`` its C entry point (in the part that
    :data:`PARTS` assigns the launch, for a source built in parts)."""
    part_of = PARTS[source][1] if source in PARTS else None

    def launch(
        *,
        dtype_code: int,
        code: int,
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
        flags = int(semiseparable) | int(compensated) << 1 | int(per_member) << 2
        _call(source, entry, what, dtype_code, code, flags, coef, state_in, state_out,
              batch, dt, iters_p, iters_q, steps_per_call, len(weights), _weights(weights),
              stream, part=None if part_of is None else part_of(dtype_code, code))
        launch.launches += 1

    return launch


#: Launch the fused-step kernel (K1) of the serial chain (``csrc/
#: fused_step.cu``; ``code`` is its n, ``semiseparable`` picks the forms) on
#: raw device pointers (``data_ptr()`` ints) and a stream handle; the caller
#: has validated every argument (``ops.fused_step.fused_step_kernel``).
#: ``coef`` is the shared table, or the ``(L, B)`` per-member one when
#: ``per_member``; ``weights`` is the tuple of 1 to 5 composition weights.
#: Raises if the launch fails.
fused_step_launch = _k1_launcher("fused_step", "hamilton_fused_step", "fused-step")

#: K1 for the chain's Möbius and L⁻¹ forms and its dense forms at n = 4
#: (``csrc/chain_variants.cu``): as :func:`fused_step_launch`, with ``code``
#: the case of the library's dispatch (``ops.fused_step.
#: KERNEL_INSTANTIATIONS``) and ``semiseparable`` False.
chain_variants_launch = _k1_launcher("chain_variants", "hamilton_chain_variant_step",
                                     "chain-variant step")


def linv_layout(dtype_code: int, code: int, compensated: bool = True,
                per_member: bool = False) -> Tuple[int, int, int, int]:
    """The L⁻¹ kernel of ``chain_variants``' case ``code`` (2: n = 20, 3:
    n = 5) as its library was built: ``(lanes a member, threads a block,
    dynamic shared bytes a block, blocks an SM)``, the last the blocks of
    its instantiation in these modes (not composed) that the card holds at
    once by its registers and shared memory.  Builds the library's part at
    first use; raises for another case."""
    out = (_INT * 4)()
    flags = int(compensated) << 1 | int(per_member) << 2
    _call("chain_variants", "hamilton_linv_layout", "L⁻¹ layout", dtype_code, code, flags, out,
          part=PARTS["chain_variants"][1](dtype_code, code))
    return tuple(out)

#: K1 for the bundled model families (``csrc/family_step.cu``): as
#: :func:`fused_step_launch`, with ``code`` the family's case of the
#: library's dispatch (``ops.fused_step.KERNEL_INSTANTIATIONS``) and
#: ``semiseparable`` False; ``coef`` may be null for room, which has no table.
family_step_launch = _k1_launcher("family_step", "hamilton_family_step", "family-step")


def user_family_launch(
    *,
    key: str,
    dtype_code: int,
    const_table: bool,
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
    """K1 for a generated family (``csrc/user_family_step.cu`` around the
    header :func:`build_user_family` built as ``key``): as
    :func:`fused_step_launch`, with ``const_table`` for the flat float64
    constant table (null when the family has none), else a run-time table of
    the state's dtype, shared or (``per_member``) ``(L, B)``.  Raises if the
    launch fails."""
    flags = int(compensated) << 1 | int(per_member) << 2
    _call("user_family", "hamilton_user_family_step", "generated family step", dtype_code,
          0 if const_table else 1, flags, coef, state_in, state_out, batch, dt, iters_p,
          iters_q, steps_per_call, len(weights), _weights(weights), stream, part=key)
    user_family_launch.launches += 1


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
    "chain_variants": chain_variants_launch,
    "family_step": family_step_launch,
    "user_family": user_family_launch,
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
