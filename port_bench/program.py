"""The system under test: ``hamilton_tpu_torch``'s ensemble driver on a
cell's configuration.

The benchmark takes from the program only this: the model factory, the
chunked ensemble driver (``evolve_ensemble_chunked``), the kernels'
builds and launch counters, and the layout
of the stepper's carry (``ops/fused_step.py``: ``q, p``, the Kahan residuals
``cq, cp`` when compensated, then the warm starts ``a_est, vdot_est``),
which the check reads to take up the program's own state.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from port_bench.reference.serial_chain import StepState

__all__ = ["JobOutput", "ProgramSUT"]


class JobOutput(NamedTuple):
    """A finished job as the host holds it: the final state and the
    per-member sampled drift maximum (None where the cell samples none),
    and, where the job was picked for the check, the carry at the start and
    the end of chunk ``snap_chunk`` on the device (``snap_start`` None for
    chunk 0, which starts from the job's initial state)."""

    final_q: torch.Tensor
    final_p: torch.Tensor
    drift: Optional[torch.Tensor]
    snap_chunk: Optional[int]
    snap_start: Optional[torch.Tensor]
    snap_end: Optional[torch.Tensor]


def _state_tensor(carry):
    # a parameter sweep's carry is (state, table)
    return carry[0] if isinstance(carry, tuple) else carry


class ProgramSUT:
    """One cell's configuration on ``hamilton_tpu_torch``."""

    def __init__(self, cell, device):
        from hamilton_tpu_torch import kernels, models

        self.cell = cell
        self.device = torch.device(device)
        integ = cell.config["integrator"]
        self.integ = integ
        self.dtype = getattr(torch, integ["dtype"])
        prog = cell.config["program"]
        self.example = getattr(models, prog["model"])(**prog["kwargs"], device=self.device,
                                                      dtype=self.dtype)
        self.system = self.example.system
        sampler = cell.config.get("sampler")
        self.sampler = sampler if cell.drift_every else None
        self._kernels = kernels

    # ---- set-up ------------------------------------------------------------
    def build_units(self):
        """The kernel units the cell's launches need: K1's part of its source
        (the program's routing tables) and the sampler's source."""
        from hamilton_tpu_torch.ops.fused_step import KERNEL_INSTANTIATIONS

        forms = self.system.fused_forms(self.system)
        key = (forms.name, forms.n, sum(forms.coef_lens))
        units = []
        if key in KERNEL_INSTANTIATIONS:
            source, code = KERNEL_INSTANTIATIONS[key]
            parts = None
            if source in self._kernels.PARTS:
                dtype_code = {torch.float32: 0, torch.float64: 1}[self.dtype]
                parts = (self._kernels.PARTS[source][1](dtype_code, code,
                                                        forms.name == "serial_chain_on"),)
            units.append((source, parts))
        if self.sampler is not None:
            units.append((self.sampler["source"], None))
        return units

    def build(self) -> int:
        """Build (or load) the cell's kernel units at once; the nvcc runs
        this took."""
        if self.device.type != "cuda":
            return 0
        units = self.build_units()
        with ThreadPoolExecutor(max_workers=max(len(units), 1)) as pool:
            futures = [pool.submit(self._kernels.build, name, parts) for name, parts in units]
        for f in futures:
            f.result()
        return int(self._kernels.NVCC_RUNS["count"])

    # ---- the timed path ------------------------------------------------------
    def run_job(self, q0: torch.Tensor, p0: torch.Tensor, snap_chunk: Optional[int],
                steps: Optional[int] = None) -> JobOutput:
        """One job: the driver over the horizon, its final state and drift
        read back to the host.  With ``snap_chunk``, the carry at that
        chunk's start and end is kept on the device: only such a job hands
        the driver a chunk callback, which has it synchronize the card at
        every chunk's end; every other job runs as a user's would."""
        from hamilton_tpu_torch.ensemble import evolve_ensemble_chunked
        from hamilton_tpu_torch.state import Phase

        integ = self.integ
        chunk = int(integ["chunk_steps"])
        snaps: Dict[str, torch.Tensor] = {}

        def on_chunk(ci, carry, drift):
            with record_function("port_bench.snapshot"):
                if ci == snap_chunk - 1:
                    snaps["start"] = _state_tensor(carry).clone()
                elif ci == snap_chunk:
                    snaps["end"] = _state_tensor(carry).clone()

        drift_every = self.cell.drift_every
        with record_function("port_bench.evolve"):
            final, drift = evolve_ensemble_chunked(
                self.system, Phase(q0, p0), integ["dt"],
                self.cell.steps if steps is None else steps,
                chunk_steps=chunk, method=integ["method"], iters=tuple(integ["iters"]),
                compensated=integ["compensated"], track_drift=drift_every is not None,
                drift_every=drift_every or chunk,
                drift_dtype=None if self.sampler is None else getattr(torch, self.sampler["dtype"]),
                steps_per_call=integ["steps_per_call"],
                carry_callback=None if snap_chunk is None else on_chunk,
            )
        with record_function("port_bench.readback"):
            host = (final.q.cpu(), final.p.cpu(), None if drift is None else drift.cpu())
        return JobOutput(*host, snap_chunk, snaps.get("start"), snaps.get("end"))

    def state_of(self, carry: torch.Tensor) -> StepState:
        """A kept carry as ``(B, n)`` float64 columns, the Kahan residuals
        added back."""
        s = carry.double()
        if self.integ["compensated"]:
            return StepState((s[0] + s[2]).T, (s[1] + s[3]).T, s[4].T, s[5].T)
        return StepState(s[0].T, s[1].T, s[2].T, s[3].T)

    # ---- counters ------------------------------------------------------------
    def reset_counts(self) -> None:
        self._kernels.reset_launches()

    def counts(self) -> Dict[str, int]:
        return self._kernels.launch_counts()

    def expected_counts(self, jobs: int) -> Optional[Dict[str, int]]:
        """The launches ``jobs`` whole jobs make on the card: K1 once a
        launch of ``steps_per_call`` steps, the sampler's solve once for
        ``H₀`` and once a sample; None off the card (the plain version
        launches nothing)."""
        if self.device.type != "cuda":
            return None
        want = {name: 0 for name in self._kernels.launch_counts()}
        steps = self.cell.steps
        want[self.cell.config["step_launcher"]] = jobs * steps // self.integ["steps_per_call"]
        if self.sampler is not None:
            want[self.sampler["launcher"]] = jobs * (1 + steps // self.cell.drift_every)
        return want
