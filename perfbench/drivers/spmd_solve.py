"""Driver of the SPMD flat solve: ``ConsensusSession.flat(..., mesh=)``
on a mesh of one rank a card, data (the cell's chips) x model 1, over
NCCL (gloo on the CPU). A step is one epoch of ``core/sharded.py`` on
every rank: each differentiates its N / chips workers' rows, the partial
edge-masked sum of their w goes into one all-reduce over the data group,
and the server step is B3 (``prox_consensus``) on the whole (M, dblk)
ring, which every rank holds.

Rank 0 runs in the harness's process on ``run.device``; ranks 1.. are
processes of this module (``python -m perfbench.drivers.spmd_solve``),
rank r on card r. A rank that dies fails the run and never hangs it:
rank 0 watches the others and ends the run with exit code ``RANK_DIED``
as soon as one exits with an error; every collective times out after
``GROUP_TIMEOUT_S``, with NCCL's async error handling on; a rank whose
parent has gone exits; and every rank is killed and waited for on every
way out of ``run``.

Set-up draws the worker data on each rank's card from the seed (the
session keeps the rank's rows) and runs ``warmup_steps`` epochs. Then
rank 0 times ``calibration_steps`` more, sets the count of epochs that
fills ``--seconds`` at that rate and broadcasts it: the window is that
many epochs on every rank (``harness/counted.py``). With ``--trace 1``
rank 0 alone runs under the profiler, and every per-layer metric and the
device's busy and window seconds are read from its trace; the other
ranks step untraced (and wait in the all-reduce for the profiled one).

Every rank looks at its own ``sys.modules`` when it is done: a rank
that has loaded JAX or the JAX package names them and exits with
``FORBIDDEN_LOADED``, which fails the run (rank 0's own are the
harness's to look at).

The check: rank 0 gathers every rank's final y, w cache and x rows and
z ring, replays every epoch of the run (set-up's and the window's) in
``reference/flat_admm.py``, the single-card algorithm, from the same
inputs, and compares the tables as ``flat_solve`` does; ``z_rank_gap``
is the widest gap between any rank's final ring and rank 0's.
"""
from __future__ import annotations

import argparse
import datetime
import importlib
import json
import math
import os
import subprocess
import sys
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..counts import spmd as spmd_counts
from ..harness import check, counted, inputs, manifest, trace, traffic, window
from ..harness.cell import Outcome, loaded_forbidden
from ..reference import flat_admm
from . import common, flat_solve

HOST = "127.0.0.1"
GROUP_TIMEOUT_S = 180        # a collective that waits longer fails the run
JOIN_S = 60                  # for the other ranks to leave once gathered
POLL_S = 0.2
EXITING_S = 5.0              # for a rank whose sockets closed to be reaped
RANK_DIED = 4                # exit code: another rank exited with an error
ORPHANED = 5                 # exit code of a rank whose parent has gone
FORBIDDEN_LOADED = 3         # exit code of a rank that loaded JAX


def run(run, plant: Optional[str] = None):
    """One run of the cell; ``plant`` ("module:function", tests only) is
    called in every rank with (rank, world) once it has joined the
    group, to plant a fault in that rank's process."""
    cell, dev = run.cell, run.device
    cfg = cell.config
    if cfg["loss"] != "quadratic" or not cfg["track_x"]:
        raise ValueError("spmd_solve runs the quadratic loss with x tracked")
    world, N = cell.chips, cfg["num_workers"]
    if N % world:
        raise ValueError(f"{N} workers do not divide over {world} ranks")
    job = {"cell": {"name": cell.name, "chips": cell.chips,
                    "config": cell.config, "workload": cell.workload,
                    "end_to_end": cell.end_to_end,
                    "per_layer": cell.per_layer},
           "seed": run.seed, "seconds": run.seconds, "world": world,
           "trace": run.trace,
           "backend": "nccl" if dev.type == "cuda" else "gloo",
           "plant": plant}
    os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = "1"
    # the rendezvous listens before any rank starts, on a port the
    # system picks as it binds (one picked beforehand can be taken)
    store = dist.TCPStore(HOST, 0, world, is_master=True,
                          timeout=_timeout(), wait_for_workers=False)
    job["port"] = store.port
    with _Ranks(job) as ranks:
        mine = _take_part(0, job, dev, run.trace_path, store)
        ranks.join()
    del store

    # the check: the single-card reference from the same inputs
    t0 = time.perf_counter()
    s = flat_solve.settings(cell)
    M, dim = cfg["num_blocks"], cfg["dim"]
    edge = traffic.edges(cell.params["edges"], N, M, dev)
    want = flat_admm.replay(inputs.centers(run.seed, N, dim, dev), edge, s,
                            run.seed, mine["epochs"])
    answer = mine["answer"]
    gaps = flat_solve.state_gaps(answer, want)
    gaps["z_rank_gap"] = max(check.table_gap(z, answer["z_hist"])
                             for z in mine["rings"])
    reference_s = time.perf_counter() - t0
    del want, answer, mine["answer"], mine["rings"]
    common.free(dev)

    win, peak = mine["window"], mine["peak"]
    dblk = flat_admm.table_shape(dim, M)[1]
    counts = spmd_counts.epoch(edge.cpu().tolist(), s["block_fraction"],
                               dblk, True, range(N // world))
    e2e = {"setup_s": win.start_wall - run.t_start,
           "epoch_ms": 1e3 * win.seconds / win.steps,
           "peak_mem_gb": None if peak is None else peak / 1e9}
    if win.step_ms:
        e2e["epoch_ms_p95"] = window.p95(win.step_ms)
    return Outcome(end_to_end=e2e, counts=counts,
                   checks=check.checks(gaps, cell.limits),
                   attempted=win.steps, failed=mine["failed"],
                   memory_peak_bytes=peak, window=win,
                   summary=mine["summary"],
                   notes={"setup_peak_bytes": mine["setup_peak"],
                          "rank_peaks_bytes": mine["peaks"],
                          "epochs": mine["epochs"],
                          "window_steps": win.steps,
                          "window_s": win.seconds,
                          "calibration_ms": mine["calibration_ms"],
                          "reference_s": reference_s})


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=GROUP_TIMEOUT_S)


class _Ranks:
    """Ranks 1 .. world - 1 as processes of this module, watched from a
    thread of rank 0's process: one that exits with an error ends the
    run at once (no rank is left waiting in a collective)."""

    def __init__(self, job):
        self.job = job
        self.procs = []
        self.done = threading.Event()
        self.watcher = threading.Thread(target=self._watch, daemon=True)

    def __enter__(self):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(manifest.ROOT), str(manifest.ROOT / "src")]
            + [p for p in [env.get("PYTHONPATH")] if p])
        try:
            for rank in range(1, self.job["world"]):
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, "--rank", str(rank),
                     "--job", json.dumps(self.job)],
                    cwd=manifest.ROOT, env=env, stdin=subprocess.DEVNULL,
                    stdout=2))    # the result line is rank 0's alone
        except BaseException:
            self.kill()
            raise
        self.watcher.start()
        return self

    def _watch(self):
        while not self.done.wait(POLL_S):
            if self.died() and not self.done.is_set():
                self.kill()
                os._exit(RANK_DIED)

    def died(self, wait: float = 0.0) -> bool:
        """Whether a rank has exited with an error (named on stderr),
        looking for up to ``wait`` seconds."""
        deadline = time.monotonic() + wait
        while True:
            dead = [(rank, proc.poll()) for rank, proc in
                    enumerate(self.procs, 1) if proc.poll() not in (None, 0)]
            if dead or time.monotonic() >= deadline:
                break
            time.sleep(POLL_S)
        for rank, code in dead:
            print(f"spmd_solve: rank {rank} exited with code {code}; "
                  f"ending the run", file=sys.stderr, flush=True)
        return bool(dead)

    def join(self):
        """Wait for every rank to leave; raises unless each exited
        cleanly."""
        self.done.set()
        codes = []
        for proc in self.procs:
            try:
                codes.append(proc.wait(timeout=JOIN_S))
            except subprocess.TimeoutExpired:
                codes.append(None)
        if any(code != 0 for code in codes):
            raise RuntimeError(f"spmd_solve: ranks 1.. exited with {codes}")

    def kill(self):
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()

    def __exit__(self, kind, *exc):
        self.done.set()
        if kind is not None:     # a collective may have found a rank gone
            self.died(wait=EXITING_S)
        self.kill()
        if self.watcher.is_alive():
            self.watcher.join()
        return False


def _take_part(rank: int, job: dict, dev: torch.device, trace_path,
               store) -> Optional[dict]:
    """Everything rank ``rank`` does in the group: set-up, the window
    (rank 0's traced to ``trace_path`` with ``--trace 1``), and the
    gather of its peak and final tables to rank 0. Returns rank 0's
    readings (None on the others)."""
    from repro_torch.api import ConsensusSession
    from repro_torch.configs.base import ADMMConfig
    from repro_torch.launch.mesh import make_mesh

    cell = manifest.Cell(**job["cell"])
    cfg, params, world = cell.config, cell.params, job["world"]
    seed = job["seed"]
    common.set_precision(cfg)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    common.reset_peak(dev)
    dist.init_process_group(job["backend"], store=store, rank=rank,
                            world_size=world, timeout=_timeout())
    try:
        if job["plant"]:
            module, name = job["plant"].split(":")
            getattr(importlib.import_module(module), name)(rank, world)
        mesh = make_mesh((world, 1), ("data", "model"))
        s = flat_solve.settings(cell)
        N, M, dim = cfg["num_workers"], cfg["num_blocks"], cfg["dim"]
        acfg = ADMMConfig(rho=s["rho"], gamma=s["gamma"],
                          max_delay=s["max_delay"],
                          block_fraction=s["block_fraction"], num_blocks=M,
                          l1_coef=s["l1_coef"], clip=s["clip"],
                          block_selection=s["block_selection"], seed=seed)
        edge = traffic.edges(params["edges"], N, M, dev)
        data = inputs.centers(seed, N, dim, dev)
        sess = ConsensusSession.flat(flat_solve.quad_loss, data, dim=dim,
                                     cfg=acfg, edge=edge, device=dev,
                                     mesh=mesh)
        del data
        state = sess.init()
        for _ in range(int(params["warmup_steps"])):
            state, _ = sess.step(state)

        # the window's count, from rank 0's rate over the calibration
        calibration = int(params["calibration_steps"])
        window.sync(dev)
        t0 = time.perf_counter()
        for _ in range(calibration):
            state, _ = sess.step(state)
        window.sync(dev)
        per_step = (time.perf_counter() - t0) / calibration
        count = torch.tensor([max(1, math.ceil(job["seconds"] / per_step))],
                             dtype=torch.int64, device=dev)
        dist.broadcast(count, src=0)
        count = int(count.item())

        held, losses = [state], []
        del state

        def step(_k):
            held[0], info = sess.step(held[0])
            losses.append(info["loss"])

        window.sync(dev)
        setup_peak = common.peak_bytes(dev)
        with trace.profiled(job["trace"] and rank == 0, trace_path) as tr:
            win = counted.run(step, count, dev)
        peak = common.peak_bytes(dev)
        summary = (trace.summarize(tr.trace, count)
                   if tr.trace is not None else None)
        peaks = _gather_peaks(peak, world, dev)
        failed = common.non_finite(losses)
        final = held[0]
        del held, losses, sess
        rings = _gather(final.z_hist, rank, world)
        answer = {k: _gather(getattr(final, k), rank, world)
                  for k in ("y", "w_cache", "x")}
        epochs = final.t
        del final
        window.sync(dev)          # the gathers done before the group goes
        common.free(dev)
        if rank:
            return None
        answer = {k: torch.cat(v) for k, v in answer.items()}
        answer["z_hist"] = rings[0]
        return {"window": win, "summary": summary, "epochs": epochs,
                "failed": failed, "peak": None if peaks is None
                else max(peaks), "peaks": peaks, "setup_peak": setup_peak,
                "answer": answer, "rings": rings,
                "calibration_ms": 1e3 * per_step}
    finally:
        dist.destroy_process_group()


def _gather_peaks(peak, world: int, dev):
    """Every rank's peak bytes on rank 0's side (all ranks take part);
    None without a card."""
    if peak is None:
        return None
    got = torch.zeros(world, dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(
        got, torch.tensor([peak], dtype=torch.int64, device=dev))
    return got.tolist()


def _gather(tensor, rank: int, world: int):
    """``tensor`` of every rank, in rank order, on rank 0 (None
    elsewhere)."""
    tensor = tensor.contiguous()
    got = ([torch.empty_like(tensor) for _ in range(world)] if rank == 0
           else None)
    dist.gather(tensor, gather_list=got, dst=0)
    return got


def _orphan_watch(parent: int):
    while True:
        time.sleep(1.0)
        if os.getppid() != parent:
            os._exit(ORPHANED)


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of spmd_solve")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--job", required=True)
    args = ap.parse_args(argv)
    job = json.loads(args.job)
    threading.Thread(target=_orphan_watch, args=(os.getppid(),),
                     daemon=True).start()
    dev = (torch.device("cuda", args.rank) if job["backend"] == "nccl"
           else torch.device("cpu"))
    if dev.type == "cpu":
        torch.set_num_threads(1)
    store = dist.TCPStore(HOST, job["port"], job["world"], is_master=False,
                          timeout=_timeout())
    _take_part(args.rank, job, dev, None, store)
    found = loaded_forbidden()
    if found:
        print(f"spmd_solve: rank {args.rank} refused: modules {found} were "
              f"loaded in its process", file=sys.stderr, flush=True)
        return FORBIDDEN_LOADED
    return 0


if __name__ == "__main__":
    sys.exit(_main())
