"""Replay PS runtime traces through the SPMD epoch on 8 spawned ranks.

The reference replays the churn, lossy and server_crash traces of
``benchmarks/speedup.py`` on a data 4 x model 2 mesh of 8 devices seen
by one process. The port's SPMD epoch runs one process per rank, so
``replay_spmd`` spawns 8 ranks of a gloo group (on the session's
device: the CPU, or all on one card), each builds
``launch.mesh.make_test_mesh(8)`` and the scenario's session over it
with the trace's ``TraceDelay``, replays every round of every trace it
is given, and reports the largest |z_replay - z_runtime| it saw. One
spawn replays any number of traces, and can carry other work for the
same 8 ranks (``extra``).
"""
from __future__ import annotations

import datetime
import json
import pickle
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


def _rank(rank: int, world: int, init_method: str, jobs_file: str,
          session_kw: dict, device: str, out_dir: str, extra=None,
          t_spawn: float = 0.0) -> None:
    """One rank: replay every job (read from ``jobs_file``) through the
    sharded epoch, then run ``extra`` (see ``replay_spmd``). ``clock``
    books the wall seconds since ``t_spawn`` (the parent's
    ``time.time()`` at the spawn) at which the rank started, joined the
    group and ended each job."""
    clock = {"started": time.time() - t_spawn}
    with open(jobs_file, "rb") as f:
        jobs = pickle.load(f)
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
    clock["joined"] = time.time() - t_spawn
    try:
        mesh = make_test_mesh(world, MODEL)
        out = {"coords": dict(mesh.coords), "errs": {}, "launches": {},
               "rounds": {}, "clock": clock}
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
            clock[name] = time.time() - t_spawn
        if extra is not None:
            fn, args = extra
            torch.save(fn(rank, mesh, *args),
                       Path(out_dir) / f"rank{rank}_extra.pt")
            clock["extra"] = time.time() - t_spawn
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def replay_spmd(jobs: Dict[str, dict], session_kw: dict,
                device="cpu", extra=None):
    """Spawn WORLD gloo ranks once and replay every job (``trace_job``)
    through ``speedup.build_session(**session_kw)`` on the (data 4, model
    2) mesh. Returns, by job: the largest replay error over the ranks
    and rounds (``err``), the rounds, each rank's launches by kernel,
    the spawn's wall seconds (start to join, all jobs) and each rank's
    ``clock`` (seconds into the spawn at which it started, joined the
    group and ended each job: where the spawn's time went).

    ``extra``, a pair (fn, args) of a picklable function, is other work
    for the same ranks: after the replays each rank calls
    ``fn(rank, mesh, *args)`` in the process group, and the return is
    then (the replays as above, the list of ``fn``'s results by rank)."""
    import torch.multiprocessing as mp

    t0, t_spawn = time.perf_counter(), time.time()
    dev = str(torch.device(device))
    with tempfile.TemporaryDirectory() as tmp:
        # the traces go through a file: arguments past a pipe's buffer
        # make each process's start wait until the one before it has
        # imported torch (the ranks then start ~8 s apart on a card)
        jobs_file = str(Path(tmp) / "jobs.pkl")
        with open(jobs_file, "wb") as f:
            pickle.dump(jobs, f)
        ctx = mp.start_processes(
            _rank, args=(WORLD, f"file://{tmp}/store", jobs_file, session_kw,
                         dev, tmp, extra, t_spawn),
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
        extras = None if extra is None else [
            torch.load(Path(tmp) / f"rank{r}_extra.pt") for r in range(WORLD)]
    seconds = time.perf_counter() - t0
    out = {name: {"err": max(r["errs"][name] for r in ranks),
                  "rounds": ranks[0]["rounds"][name],
                  "launches_per_rank": [r["launches"][name] for r in ranks],
                  "spawn_seconds": seconds,
                  "rank_clock_s": [r["clock"] for r in ranks]}
           for name in jobs}
    return out if extra is None else (out, extras)
