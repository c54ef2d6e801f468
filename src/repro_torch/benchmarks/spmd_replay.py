"""Replay PS runtime traces through the SPMD epoch on 8 spawned ranks.

The reference replays the churn, lossy and server_crash traces of
``benchmarks/speedup.py`` on a data 4 x model 2 mesh of 8 devices seen
by one process. The port's SPMD epoch runs one process per rank, so
``replay_spmd`` spawns 8 ranks of a gloo group (on the session's
device: the CPU, or all on one card), each builds
``launch.mesh.make_test_mesh(8)`` and the scenario's session over it
with the trace's ``TraceDelay``, replays every round of every trace it
is given, and reports the largest |z_replay - z_runtime| it saw. One
spawn replays any number of traces.
"""
from __future__ import annotations

import datetime
import json
import tempfile
import time
from pathlib import Path
from typing import Dict

import numpy as np
import torch

WORLD = 8                      # make_test_mesh(8): data 4 x model 2
MODEL = 2
MESH_NAME = "data4xmodel2"
PG_TIMEOUT_S = 300             # a collective that waits longer fails
JOIN_S = 900                   # the ranks, all together


def trace_job(res) -> dict:
    """What a rank needs of a ``PSRunResult`` to replay it: the trace's
    delays and participation, and the runtime's z after every round."""
    trace = res.trace
    return {"delays": np.asarray(trace.delays),
            "participation": (None if trace.participation is None
                              else np.asarray(trace.participation)),
            "z": np.stack([torch.as_tensor(z).cpu().numpy()
                           for z in res.z_versions])}


def _rank(rank: int, world: int, init_method: str, jobs: Dict[str, dict],
          session_kw: dict, device: str, out_dir: str) -> None:
    """One rank: replay every job through the sharded epoch."""
    import torch.distributed as dist

    from ..core.space import TraceDelay
    from ..kernels import ops
    from ..launch.mesh import make_test_mesh
    from .speedup import build_session

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        mesh = make_test_mesh(world, MODEL)
        out = {"coords": dict(mesh.coords), "errs": {}, "launches": {},
               "rounds": {}}
        for name, job in jobs.items():
            dm = TraceDelay(job["delays"], participation=job["participation"])
            sess = build_session(delay_model=dm, mesh=mesh, device=device,
                                 **session_kw)
            state = sess.init()
            z_run = torch.as_tensor(job["z"])
            ops.reset_launch_counts()
            err = 0.0
            for t in range(z_run.shape[0] - 1):
                state, _ = sess.step(state)
                err = max(err, float(torch.max(torch.abs(
                    z_run[t + 1] - sess.z(state).cpu()))))
            out["errs"][name] = err
            out["launches"][name] = {k: n for k, n in
                                     ops.launch_counts().items() if n}
            out["rounds"][name] = z_run.shape[0] - 1
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def replay_spmd(jobs: Dict[str, dict], session_kw: dict,
                device="cpu") -> Dict[str, dict]:
    """Spawn WORLD gloo ranks once and replay every job (``trace_job``)
    through ``speedup.build_session(**session_kw)`` on the (data 4, model
    2) mesh. Returns, by job: the largest replay error over the ranks
    and rounds (``err``), the rounds, each rank's launches by kernel,
    and the spawn's wall seconds (start to join, all jobs)."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    dev = str(torch.device(device))
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank, args=(WORLD, f"file://{tmp}/store", jobs, session_kw, dev,
                         tmp),
            nprocs=WORLD, start_method="spawn", join=False)
        deadline = time.monotonic() + JOIN_S
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise RuntimeError(f"spmd replay: the {WORLD} ranks did "
                                       f"not finish within {JOIN_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(WORLD)]
    seconds = time.perf_counter() - t0
    return {name: {"err": max(r["errs"][name] for r in ranks),
                   "rounds": ranks[0]["rounds"][name],
                   "launches_per_rank": [r["launches"][name] for r in ranks],
                   "spawn_seconds": seconds}
            for name in jobs}
