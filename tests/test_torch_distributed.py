"""The port's sharded ensemble across two processes (gloo on the CPU).

Two worker processes open a process group on a free localhost port
(``parallel.init_distributed`` with explicit arguments), form the global
mesh of 2 ranks × 2 CPU shards (``global_ensemble_mesh``), each evolve
their half of 16 double-pendulum members (``local_batch_slice``) through
``evolve_ensemble_sharded``, and save and load their shards of the final
state with ``save_orbax``/``load_orbax`` (DCP) into one checkpoint.  The
``reduce_stats`` max and mean (one ``all_reduce`` across the ranks) must be
the single-process results over the same 4 shards, and each rank's final
members the single-process run's.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import hamilton_tpu_torch as tp
from hamilton_tpu_torch import parallel

REPO = Path(__file__).resolve().parent.parent
F64 = torch.float64
B, STEPS, DRIFT_EVERY = 16, 4, 2

WORKER = f"""
import json, sys
import numpy as np
import torch
import hamilton_tpu_torch as tp
from hamilton_tpu_torch import parallel
from hamilton_tpu_torch.utils import load_orbax, save_orbax

rank, port, ckpt = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert parallel.init_distributed(f"127.0.0.1:{{port}}", 2, rank, backend="gloo", timeout=60)
assert parallel.is_distributed()
mesh = parallel.global_ensemble_mesh(devices=["cpu", "cpu"])
assert mesh.shape == {{"ensemble": 4, "param": 1}}, mesh.shape
assert [int(r) for r in mesh.ranks.flat] == [0, 0, 1, 1]
rng = np.random.default_rng(0)
q = np.array([np.pi / 2, np.pi / 2]) + 0.01 * rng.standard_normal(({B}, 2))
sl = parallel.local_batch_slice({B})
ex = tp.double_pendulum(device="cpu", dtype=torch.float64)
ph = tp.Phase(torch.tensor(q[sl]), torch.zeros(sl.stop - sl.start, 2, dtype=torch.float64))
out = {{"slice": [sl.start, sl.stop]}}
for stat in ("max", "mean"):
    _, d = tp.evolve_ensemble_sharded(ex.system, ph, 0.01, {STEPS}, mesh=mesh,
                                      drift_every={DRIFT_EVERY}, reduce_stats=stat)
    out[stat] = float(d)
final, drift = tp.evolve_ensemble_sharded(ex.system, ph, 0.01, {STEPS}, mesh=mesh,
                                          drift_every={DRIFT_EVERY})
shards = parallel.shard_phase(final, mesh)
assert len(shards.shards) == 2
save_orbax(ckpt, shards)
back = load_orbax(ckpt, like=shards)
out["checkpoint_bitwise"] = all(torch.equal(a.q, b.q) and torch.equal(a.p, b.p)
                                for a, b in zip(shards.shards, back.shards))
out["q"] = final.q.tolist()
out["drift"] = drift.tolist()
torch.distributed.destroy_process_group()
print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_match_one(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(rank), str(port),
                               str(tmp_path / "ckpt")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=tmp_path)
             for rank in (0, 1)]
    outs = []
    try:
        for proc in procs:
            stdout, stderr = proc.communicate(timeout=120)
            assert proc.returncode == 0, stderr[-3000:]
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert [o["slice"] for o in outs] == [[0, 8], [8, 16]]
    assert all(o["checkpoint_bitwise"] for o in outs)
    # one process over the same 4 shards
    rng = np.random.default_rng(0)
    q = np.array([np.pi / 2, np.pi / 2]) + 0.01 * rng.standard_normal((B, 2))
    ex = tp.double_pendulum(device="cpu", dtype=F64)
    ph = tp.Phase(torch.tensor(q), torch.zeros(B, 2, dtype=F64))
    mesh = parallel.ensemble_mesh(["cpu"] * 4)
    final, drift = tp.evolve_ensemble_sharded(ex.system, ph, 0.01, STEPS, mesh=mesh,
                                              drift_every=DRIFT_EVERY)
    assert torch.equal(torch.tensor(outs[0]["q"] + outs[1]["q"], dtype=F64), final.q)
    assert torch.equal(torch.tensor(outs[0]["drift"] + outs[1]["drift"], dtype=F64), drift)
    for stat in ("max", "mean"):
        _, want = tp.evolve_ensemble_sharded(ex.system, ph, 0.01, STEPS, mesh=mesh,
                                             drift_every=DRIFT_EVERY, reduce_stats=stat)
        # max: the same maximum; mean: the same four shard means, summed in
        # another order across the ranks
        for o in outs:
            assert abs(o[stat] - float(want)) <= 1e-15 * abs(float(want)) + 1e-300, stat
