"""Numerical building blocks: the library path's SPD solves
(:mod:`.linalg`) and the fused whole-step leapfrog with its Hopper kernel
(:mod:`.fused_step`)."""
