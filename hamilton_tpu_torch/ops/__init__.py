"""Numerical building blocks: the library path's SPD solves (:mod:`.linalg`)
over the batched tiny-SPD kernels (:mod:`.batched_spd`), and the fused
whole-step leapfrog with its Hopper kernel (:mod:`.fused_step`)."""

from hamilton_tpu_torch.ops.linalg import cholesky_solve, spd_cholesky, spd_solve

__all__ = ["spd_solve", "spd_cholesky", "cholesky_solve"]
