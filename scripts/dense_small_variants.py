#!/usr/bin/env python3
"""Copies of the port, each with one lever of K1's one-thread dense chain
(n = 2 in ``csrc/fused_step.cu``, n = 4 in ``csrc/chain_variants.cu``) or
of its L⁻¹ lane step (``csrc/chain_lanes.cuh``) changed, for
``scripts/torch_ab.py`` to time against the tree in one call.

    python3 scripts/dense_small_variants.py [--tree DIR] VARIANT [VARIANT ...]

VARIANT is one of

- ``runtime-iters``: ``csrc/fused_step.cuh``'s ``with_iters`` takes no
  count as a constant, so the dense kernels read ``iters_p`` and
  ``iters_q`` at run time for every count;
- ``pivot-per-factor``: the dense chain's factor takes its first pivot,
  sqrt(C_00) and its reciprocal, at every factorization again instead of
  once a launch (``csrc/chain_forms.cuh``'s ``DenseChainTable``);
- ``block32``, ``block64``: the dense n = 4 kernel launched with 32 or 64
  threads a block instead of 128 (``fit_masses``' 1024 members then spread
  over 32 or 16 SMs instead of 8);
- ``linv-straight-aux``: the L⁻¹ lane step's aux takes the straight-line
  sine-cosine at every n (the tree: up to ``kLinvStraightAuxUpTo``);
- ``linv-aux-only``: as ``linv-straight-aux``, and its generator recursion
  takes the library's sqrt and 1/d, as before its straight-line pass;
- ``linv-generators-only``: its aux takes sin and cos one by one (the
  library's ``sinf`` and ``cosf``) at every n, and keeps the straight-line
  generators.

Each copy of DIR's package (default: this checkout's) is written to
``_archive/<VARIANT>/hamilton_tpu_torch`` (``_archive/`` is gitignored) and
its directory printed, e.g.::

    python3 scripts/dense_small_variants.py runtime-iters block32
    python3 scripts/torch_ab.py --rounds 5 --only double_pendulum,chaos_scan,fit_masses \\
        _archive/parent . _archive/runtime-iters _archive/block32

Raises where the source no longer holds the text a lever changes (a
variant may change several).
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_LAUNCH = '''    const long long blocks = (a.batch + kThreads - 1) / kThreads;
    auto go = [&](auto it) {
      using I = decltype(it);
      chain_variant_kernel<T, CASE, COMP, PM, COMPOSED, I::kP, I::kQ>
          <<<static_cast<unsigned int>(blocks), kThreads, bytes, a.stream>>>('''


def _block(threads: int):
    return ("csrc/chain_variants.cu", _LAUNCH, _LAUNCH.replace(
        "    const long long blocks = (a.batch + kThreads - 1) / kThreads;",
        f"    constexpr int kBlock = CASE == 4 ? {threads} : kThreads;\n"
        "    const long long blocks = (a.batch + kBlock - 1) / kBlock;").replace(
        "blocks), kThreads, bytes", "blocks), kBlock, bytes"))


def _linv_aux(straight: str):
    return ("csrc/chain_lanes.cuh",
            "struct LinvLaneForms : LaneTrig<Sh, (Sh::N <= kLinvStraightAuxUpTo)> {",
            f"struct LinvLaneForms : LaneTrig<Sh, {straight}> {{")


_LINV_GENERATORS = (
    "csrc/chain_lanes.cuh",
    "    if (!lane_generators_pass<true, Sh>(cf)) lane_generators_pass<false, Sh>(cf);\n",
    "    lane_generators_pass<false, Sh>(cf);\n")

#: variant → (file in the package, the text it holds, the text it gets),
#: three more for each further text it changes
VARIANTS = {
    "runtime-iters": ("csrc/fused_step.cuh",
                      "  if (iters_p == 2 && iters_q == 1) return f(IterCounts<2, 1>{});\n"
                      "  if (iters_p == 3 && iters_q == 1) return f(IterCounts<3, 1>{});\n",
                      ""),
    "pivot-per-factor": ("csrc/chain_forms.cuh", "      f, &cf.first);\n", "      f);\n"),
    "block32": _block(32),
    "block64": _block(64),
    "linv-straight-aux": _linv_aux("true"),
    "linv-aux-only": _linv_aux("true") + _LINV_GENERATORS,
    "linv-generators-only": _linv_aux("false"),
}


def main(argv) -> int:
    tree = ROOT
    if len(argv) >= 2 and argv[0] == "--tree":
        tree, argv = Path(argv[1]), argv[2:]
    if not argv or any(v not in VARIANTS for v in argv):
        print(__doc__, file=sys.stderr)
        return 2
    for variant in argv:
        where = ROOT / "_archive" / variant
        pkg = where / "hamilton_tpu_torch"
        if pkg.exists():
            shutil.rmtree(pkg)
        shutil.copytree(tree / "hamilton_tpu_torch", pkg,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        edits = VARIANTS[variant]
        for k in range(0, len(edits), 3):
            path, old, new = edits[k:k + 3]
            src = pkg / path
            text = src.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{src}: the text {variant} changes is not there once")
            src.write_text(text.replace(old, new))
        print(where.relative_to(ROOT), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
