"""Faults planted in one or every rank of an ``spmd_solve`` run, each
``plant(rank, world)`` as the driver's ``plant`` hook calls it in every
rank's process once it has joined the group, and the tiny four-rank run
the tests plant them in."""
import dataclasses
import json
import os
import sys
import time
import types

import torch

from perfbench.drivers import spmd_solve
from perfbench.harness import cell as cell_mod
from perfbench.harness import manifest

SPMD = "kdda-8w64b.spmd_4chip"
FAULTS = "perfbench.tests.spmd_faults"


def spmd_cell() -> manifest.Cell:
    """The SPMD workload as its files hold it, with or without its
    entries in BENCHMARK.json."""
    workload = json.loads((manifest.BENCH_DIR / "workloads"
                           / f"{SPMD}.json").read_text())
    config = json.loads((manifest.BENCH_DIR / "configs"
                         / f"{workload['config']}.json").read_text())
    return manifest.Cell(name=SPMD, chips=workload["chips"], config=config,
                         workload=workload, end_to_end=[], per_layer=[])


def four_rank_cell() -> manifest.Cell:
    """The SPMD cell at dim 4,096, 8 workers and 8 blocks, on 4 ranks,
    calibrating its window on 10 epochs."""
    c = spmd_cell()
    return dataclasses.replace(
        c, config=dict(c.config, dim=4096, num_workers=8, num_blocks=8),
        workload=dict(c.workload, params=dict(c.params,
                                              calibration_steps=10)))


def run_four(plant=None, seed=2**31 + 11, seconds=0.2):
    run = cell_mod.Run(cell=four_rank_cell(), seed=seed, seconds=seconds,
                       trace=False, device=torch.device("cpu"),
                       t_start=time.time())
    out = spmd_solve.run(run, plant=None if plant is None
                         else f"{FAULTS}:{plant}")
    return cell_mod.line(run, out), out


def targets():
    """(owner, attribute) of everything a plant here replaces, so that a
    test can put back what the plants did in its own process (rank 0)."""
    from perfbench.harness import inputs
    from repro_torch import api
    from repro_torch.core import sharded, space
    return [(space._PackedOps, "reduce_workers"),
            (space._PackedOps, "server_prox"),
            (space._PackedOps, "worker_grads"),
            (sharded.MeshCollectives, "psum_data"),
            (inputs, "centers"), (api, "asybadmm_epoch")]


def unchanged_state(rank, world):
    """Rank 1's epoch returns the state it was given (one step on)."""
    if rank == 1:
        from repro_torch import api
        real = api.asybadmm_epoch

        def stuck(spec, state, data):
            _, info = real(spec, state, data)
            return state._replace(t=state.t + 1), info
        api.asybadmm_epoch = stuck


def half_batch(rank, world):
    """Every rank's gradient from half of its workers' data: the second
    half of its rows reuse the first half's."""
    from repro_torch.core import space
    real = space._PackedOps.worker_grads

    def half(self, loss_fn, z_tilde, data, *a, **k):
        n = data.shape[0] // 2
        data = torch.cat([data[:n], data[:data.shape[0] - n]])
        return real(self, loss_fn, z_tilde, data, *a, **k)
    space._PackedOps.worker_grads = half


def drop_partial_w(rank, world):
    """Rank 1 leaves its workers' partial w sum out of the all-reduce."""
    if rank == 1:
        from repro_torch.core import space
        real = space._PackedOps.reduce_workers

        def zero(self, w, edge):
            return real(self, w, edge).mul_(0.0)
        space._PackedOps.reduce_workers = zero


def no_exchange(rank, world):
    """No rank all-reduces: each takes its own workers' sums as the
    group's."""
    from repro_torch.core import sharded
    sharded.MeshCollectives.psum_data = lambda self, x: x


def other_seed(rank, world):
    """Rank 2 draws its workers' data from another seed."""
    if rank == 2:
        from perfbench.harness import inputs
        real = inputs.centers

        def centers(seed, workers, dim, device):
            return real(seed + 1, workers, dim, device)
        inputs.centers = centers


def altered_ring(rank, world):
    """Rank 3's server step alters one element of each new z."""
    if rank == 3:
        from repro_torch.core import space
        real = space._PackedOps.server_prox

        def server(self, *a, **k):
            z = real(self, *a, **k).clone()
            z[0, 0] += 1e-3
            return z
        space._PackedOps.server_prox = server


def loads_jax(rank, world):
    """Rank 2 has a module named ``jax`` in its process."""
    if rank == 2:
        sys.modules["jax"] = types.ModuleType("jax")


def exit_after_warmup(rank, world, warmup_steps=3):
    """Rank 3 dies (exit code 3) when its warm-up's epochs are done."""
    if rank == 3:
        from repro_torch import api
        real, calls = api.asybadmm_epoch, [0]

        def epoch(spec, state, data):
            if calls[0] == warmup_steps:
                os._exit(3)
            calls[0] += 1
            return real(spec, state, data)
        api.asybadmm_epoch = epoch
