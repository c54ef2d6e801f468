"""Driver of a flat consensus solve: ``ConsensusSession.flat(...).step``,
one epoch of Algorithm 1 (``core/space.py::asybadmm_epoch`` on a
``FlatSpace``, backend ``auto``: B1 and B2 on the card) per step.

Set-up draws the worker data from the seed, builds the session with the
traffic's edge set and runs ``warmup_steps`` epochs (the kernels load
or build on the first). The window steps the same state on; an epoch's
time is the gap between the CUDA events after it and after the one
before. The check replays every epoch the run made (set-up's and the
window's) in ``reference/flat_admm.py`` from the same inputs and
compares the final state table by table.
"""
from __future__ import annotations

import time

import torch

from ..counts import flat as flat_counts
from ..harness import check, inputs, trace, traffic, window
from ..harness.cell import Outcome
from ..reference import flat_admm
from . import common


def quad_loss(z, c):
    """f_i(z) = 0.5 ||z - c_i||^2, the configuration's worker loss."""
    return 0.5 * torch.sum(torch.square(z - c))


def settings(cell) -> dict:
    cfg, params = cell.config, cell.params
    s = {key: cfg[key] for key in ("rho", "gamma", "max_delay",
                                   "block_selection", "l1_coef", "clip")}
    s["block_fraction"] = params["block_fraction"]
    s.update(params.get("admm", {}))
    return s


def state_gaps(got, want) -> dict:
    """``z_gap``, ``y_gap``, ``w_gap``, ``x_gap``: each final table's
    widest gap against the reference's over its largest value."""
    return {f"{k.split('_')[0]}_gap": check.table_gap(got[k], want[k])
            for k in ("z_hist", "y", "w_cache", "x")}


def run(run):
    from repro_torch.api import ConsensusSession
    from repro_torch.configs.base import ADMMConfig

    cfg, params, dev = run.cell.config, run.cell.params, run.device
    if cfg["loss"] != "quadratic" or not cfg["track_x"]:
        raise ValueError("flat_solve runs the quadratic loss with x tracked")
    common.set_precision(cfg)
    common.reset_peak(dev)
    s = settings(run.cell)
    N, M, dim = cfg["num_workers"], cfg["num_blocks"], cfg["dim"]
    acfg = ADMMConfig(rho=s["rho"], gamma=s["gamma"],
                      max_delay=s["max_delay"],
                      block_fraction=s["block_fraction"], num_blocks=M,
                      l1_coef=s["l1_coef"], clip=s["clip"],
                      block_selection=s["block_selection"], seed=run.seed)
    edge = traffic.edges(params["edges"], N, M, dev)
    data = inputs.centers(run.seed, N, dim, dev)
    sess = ConsensusSession.flat(quad_loss, data, dim=dim, cfg=acfg,
                                 edge=edge, device=dev)
    del data
    state = sess.init()
    for _ in range(int(params["warmup_steps"])):
        state, _ = sess.step(state)
    held, losses = [state], []
    del state

    def step(_k):
        held[0], info = sess.step(held[0])
        losses.append(info["loss"])

    window.sync(dev)
    setup_peak = common.peak_bytes(dev)
    with trace.profiled(run.trace, run.trace_path) as traced:
        win = window.run(step, run.seconds, dev)
    peak = common.peak_bytes(dev)
    setup_s = win.start_wall - run.t_start
    final = held[0]
    epochs = final.t
    answer = {"z_hist": final.z_hist, "y": final.y, "w_cache": final.w_cache,
              "x": final.x}
    failed = common.non_finite(losses)
    dblk = sess.spec.space.packer.block_dim
    del final, held, sess, losses
    common.free(dev)
    summary = (trace.summarize(traced.trace, win.steps)
               if traced.trace is not None else None)

    # the check: the reference from the same inputs, every epoch again
    t0 = time.perf_counter()
    want = flat_admm.replay(inputs.centers(run.seed, N, dim, dev), edge, s,
                            run.seed, epochs)
    gaps = state_gaps(answer, want)
    reference_s = time.perf_counter() - t0
    del want, answer
    common.free(dev)

    counts = flat_counts.epoch(edge.cpu().tolist(), s["block_fraction"],
                               dblk, True)
    e2e = {"setup_s": setup_s,
           "epoch_ms": 1e3 * win.seconds / win.steps,
           "peak_mem_gb": None if peak is None else peak / 1e9}
    if win.step_ms:
        e2e["epoch_ms_p95"] = window.p95(win.step_ms)
    return Outcome(end_to_end=e2e, counts=counts,
                   checks=check.checks(gaps, run.cell.limits),
                   attempted=win.steps, failed=failed,
                   memory_peak_bytes=peak, window=win, summary=summary,
                   notes={"setup_peak_bytes": setup_peak,
                          "epochs": epochs, "window_steps": win.steps,
                          "window_s": win.seconds,
                          "reference_s": reference_s})
