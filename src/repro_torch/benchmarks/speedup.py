"""Paper Table 1 analogue: speedup of p workers performing k iterations.

    python -m repro_torch.benchmarks.speedup [--smoke] [--device cpu]
    python -m repro_torch.benchmarks.speedup --scenario churn --smoke

Port of ``benchmarks/speedup.py``. Table 1 measures the scalability of
the *coordination scheme*; the event-driven Parameter Server runtime
(``repro_torch.ps``) reproduces it. This module only

* measures the real per-event costs — one worker iteration and one
  block-server commit of the real variable-space hot path, on the
  session's device (``repro_torch.ps.timing.measure_costs``: on the
  card, the B1 and B2 kernels with a synchronize around each call);
* feeds them to the scheduler as service times (lognormal jitter, the
  stragglers Assumption 3 exists for) and sweeps workers x
  {lockfree, locked} through ``PSRuntime`` in timing-only mode;
* reports ``T_k(p)`` = makespan until k total iterations commit,
  work-shared by p workers, and ``Speedup_p = T_k(1) / T_k(p)``.

``--smoke`` runs a DETERMINISTIC locked-vs-lockfree comparison at 8
workers — constant service times in a coordination-bound regime
(worker compute pinned to 4 block-serve units, M=16, so the full-vector
lock's M-serial commit dominates) — gated against
``min_lockfree_speedup_x8`` in ``ps_baseline.json`` beside this file,
then a reduced Table 1.

``--scenario`` runs the elastic-PS studies instead of Table 1:

* ``churn``      — 8 real-compute workers under per-push commits with a
  deterministic crash+rejoin plan (``FaultPlan.churn``): replays the
  chaos trace through the vectorized epoch on one device and gates
  rounds-to-tolerance chaos/fault-free vs ``max_churn_rounds_ratio``;
* ``lossy``      — 8 real-compute workers over an unreliable transport
  (5% drop / 2% dup / 10% reorder, ack+retry reliability): gates
  rounds-to-tolerance lossy/reliable vs ``max_lossy_rounds_ratio`` and
  replay parity of the lossy trace;
* ``skew``       — timing-only zipf vs uniform block selection: hot head
  blocks pile onto few lock domains (queue-occupancy spread, gated vs
  ``min_skew_occupancy_ratio``);
* ``heavy_tail`` — Pareto worker compute: stall-time concentration under
  lockfree vs per_push commits (gated vs ``min_heavy_tail_stall``);
* ``server_crash`` — 8 real-compute workers; a deterministic plan
  crashes two block servers (blocks 2 and 9), each rebuilt by replaying
  its write-ahead commit log (on the card: B2 once per replayed block
  version). Gates: zero lost folds by per-round multiset against the
  crash-free run, 2 recoveries, rounds-to-tolerance vs
  ``max_server_crash_rounds_ratio`` and replay parity of the crash
  trace.

Each of churn, lossy and server_crash replays its trace on one device
and on the SPMD epoch over a data 4 x model 2 mesh: the reference's
8-device mesh is 8 gloo ranks here, one process each, which
``spmd_replay.replay_spmd`` spawns once per scenario on the session's
device (all on the one card, or on the CPU). Its ``*_replay_err_spmd``
line is the reference's; ``*_replay_spmd_launches`` counts each rank's
kernel launches (B1 and B3, once a round on the card; none on the CPU)
and the spawn's wall seconds.

The gates are virtual-time figures of the simulation (the reference's
values, ``benchmarks/kernels_baseline.json``), so they hold for the
port. CSV columns: name, us_per_call (simulated makespan), derived.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Callable, Dict, List

import numpy as np
import torch

from ..api import ConsensusSession
from ..configs.base import ADMMConfig
from ..data import make_sparse_logreg
from ..device import DeviceLike
from ..ps import (ConstantService, CostProfile, FaultPlan, LognormalService,
                  ParetoService, PSRuntime, Transport, measure_costs)
from .spmd_replay import MESH_NAME, replay_spmd, trace_job

K_ITERS = 320
WORKERS = [1, 4, 8, 16, 32]
M_BLOCKS = 16
GATE_WORKERS = 8
GATE_ROUNDS = 12
BASELINE = pathlib.Path(__file__).parent / "ps_baseline.json"
CHURN_DIM = M_BLOCKS * 16
SPMD_TOL = 1e-5
# the scenarios' session (build_session's arguments) and their rounds
REPLAY_SESSION = {"num_workers": GATE_WORKERS, "dim": CHURN_DIM,
                  "samples": 4}

Emit = Callable[[str], None]


def _gate(name: str) -> float:
    return json.loads(BASELINE.read_text())[name]


def loss_fn(z, d):
    X, y = d
    return torch.mean(torch.log1p(torch.exp(-y * (X @ z))))


def build_session(num_workers: int, dim: int = 2048, samples: int = 64,
                  seed: int = 0, *, block_selection: str = "random",
                  zipf_a: float = 1.1, delay_model=None, mesh=None,
                  device: DeviceLike = None) -> ConsensusSession:
    """The paper's sparse-logreg workload (eq. 22) on the session API
    (SPMD over ``mesh`` when one is given)."""
    data = make_sparse_logreg(num_workers=num_workers,
                              samples_per_worker=samples, dim=dim,
                              density=0.1, seed=seed)
    cfg = ADMMConfig(rho=2.0, gamma=0.1, max_delay=2, block_fraction=0.5,
                     num_blocks=M_BLOCKS, l1_coef=1e-3, clip=1e4, seed=seed,
                     block_selection=block_selection, zipf_a=zipf_a)
    return ConsensusSession.flat(loss_fn, (data.X, data.y), dim=dim,
                                 cfg=cfg, delay_model=delay_model,
                                 mesh=mesh, device=device)


def measured_costs(dim: int = 2048, samples: int = 64,
                   device: DeviceLike = None) -> Dict[str, float]:
    """Measured seconds of one worker iteration and one z-block commit
    on the session's device."""
    sess = build_session(1, dim=dim, samples=samples, device=device)
    return measure_costs(sess.spec, sess.data)


def makespan(p: int, k_total: int, timing: CostProfile, discipline: str,
             device: DeviceLike = None) -> float:
    """Event-driven makespan until k_total iterations commit, the work
    shared by p workers (ceil-split like the paper's fixed-k runs)."""
    rounds = -(-k_total // p)
    sess = build_session(p, dim=M_BLOCKS * 16, samples=4, device=device)
    rt = PSRuntime(sess.spec, discipline=discipline, timing=timing,
                   compute="timing")
    return rt.run(rounds).makespan


def table1(emit: Emit, costs: dict, workers=WORKERS, k_iters=K_ITERS,
           jitter: float = 0.3, device: DeviceLike = None) -> List[Dict]:
    """T_k(p) and Speedup_p for both disciplines; returns the rows."""
    rows = []
    for discipline in ("lockfree", "locked"):
        timing = CostProfile(
            t_worker=LognormalService(costs["t_worker"], jitter),
            t_server_block=LognormalService(costs["t_server_block"],
                                            jitter / 2))
        base = makespan(1, k_iters, timing, discipline, device)
        for p in workers:
            tk = base if p == 1 else makespan(p, k_iters, timing,
                                              discipline, device)
            emit(f"table1_{discipline}_p{p},{tk*1e6:.0f},"
                 f"speedup={base / tk:.2f}")
            rows.append({"discipline": discipline, "p": p, "k": k_iters,
                         "T_k": tk, "speedup": base / tk})
    return rows


def smoke_gate(emit: Emit, costs: dict, device: DeviceLike = None) -> bool:
    """Deterministic coordination-bound comparison at 8 workers:
    constant service, worker compute = 4 block-serve units. The only
    difference between the two runs is the lock discipline, so the
    makespan ratio isolates the paper's §1 claim (block-wise servers
    beat the full-vector lock). Gated vs the baseline."""
    ts = costs["t_server_block"]
    timing = CostProfile(t_worker=ConstantService(4.0 * ts),
                         t_server_block=ConstantService(ts))
    spans = {d: makespan(GATE_WORKERS, GATE_WORKERS * GATE_ROUNDS, timing, d,
                         device)
             for d in ("lockfree", "locked")}
    ratio = spans["locked"] / spans["lockfree"]
    min_ratio = _gate("min_lockfree_speedup_x8")
    emit(f"speedup_gate_lockfree_x{GATE_WORKERS},"
         f"{spans['lockfree']*1e6:.0f},ratio={ratio:.2f}")
    emit(f"speedup_gate_locked_x{GATE_WORKERS},"
         f"{spans['locked']*1e6:.0f},min_ratio={min_ratio}")
    if ratio < min_ratio:
        emit(f"speedup_gate_FAILED,0,locked/lockfree ratio {ratio:.2f} < "
             f"{min_ratio}")
        return False
    return True


# ---------------------------------------------------------------------------
# elastic-PS scenarios (--scenario)
# ---------------------------------------------------------------------------

def _emit_hist(emit: Emit, name: str, hist: dict) -> None:
    """One histogram as a CSV row: total count, then edge:count bins."""
    bins = "|".join(f"{hist['edges'][i]:.3g}:{c}"
                    for i, c in enumerate(hist["counts"]))
    emit(f"{name},{sum(hist['counts'])},bins={bins}")


def _rounds_to_tolerance(losses, tol: float):
    for t, loss in enumerate(losses):
        if np.isfinite(loss) and loss <= tol:
            return t + 1
    return None


def _replay_max_err(res, sess: ConsensusSession) -> float:
    """Max |z_replay - z_runtime| over all rounds, replaying ``res``'s
    trace through ``sess``'s vectorized epoch."""
    state = sess.init()
    err = 0.0
    for t in range(res.num_rounds):
        state, _ = sess.step(state)
        err = max(err, float(torch.max(torch.abs(
            res.z_versions[t + 1] - sess.z(state)))))
    return err


def spmd_replay_err(emit: Emit, prefix: str, res,
                    device: DeviceLike = None) -> float:
    """Replay ``res``'s trace on the 8-rank SPMD mesh (one spawn); emits
    the reference's ``<prefix>_replay_err_spmd`` line and each rank's
    launches. Returns the largest error over the ranks and rounds."""
    out = replay_spmd({prefix: trace_job(res)}, REPLAY_SESSION,
                      device=device if device is not None else "cuda")[prefix]
    emit(f"{prefix}_replay_err_spmd,{out['err']:.2e},mesh={MESH_NAME}")
    per_rank = out["launches_per_rank"]
    names = sorted({k for r in per_rank for k in r})
    emit(f"{prefix}_replay_spmd_launches,{out['rounds']},"
         + "".join(f"{k}=" + "/".join(str(r.get(k, 0)) for r in per_rank)
                   + "|" for k in names)
         + f"spawn_s={out['spawn_seconds']:.1f}")
    return out["err"]


def churn_runs(smoke: bool = False, device: DeviceLike = None):
    """The churn scenario's fault-free and chaos runs."""
    R = 16 if smoke else 24
    timing = CostProfile(t_worker=ConstantService(1.0),
                         t_server_block=ConstantService(0.25))
    plan = FaultPlan.churn(GATE_WORKERS, seed=0, crashes=2,
                           window=(2.0, 8.0), down=(2.0, 5.0))
    sess = build_session(device=device, **REPLAY_SESSION)
    ff = sess.run_ps(R, discipline="per_push", timing=timing)
    ch = sess.run_ps(R, discipline="per_push", timing=timing, faults=plan)
    return ff, ch


def lossy_runs(smoke: bool = False, device: DeviceLike = None):
    """The lossy scenario's reliable and lossy runs."""
    R = 16 if smoke else 24
    tw, ts = ConstantService(1.0), ConstantService(0.25)
    tr = Transport(0.0, 0.0, drop_rate=0.05, dup_rate=0.02,
                   reorder_rate=0.1, ack_timeout=0.5)
    sess = build_session(device=device, **REPLAY_SESSION)
    rel = sess.run_ps(R, timing=CostProfile(t_worker=tw, t_server_block=ts))
    lo = sess.run_ps(R, timing=CostProfile(t_worker=tw, t_server_block=ts,
                                           net=tr))
    return rel, lo


def server_crash_runs(smoke: bool = False, device: DeviceLike = None):
    """The server_crash scenario's crash-free and crash runtimes and
    their runs."""
    R = 16 if smoke else 24
    timing = CostProfile(t_worker=ConstantService(1.0),
                         t_server_block=ConstantService(0.25))
    plan = FaultPlan.of(FaultPlan.server_crash(2, at=3.0, down=2.5),
                        FaultPlan.server_crash(9, at=6.0, down=3.0))
    sess = build_session(device=device, **REPLAY_SESSION)
    rt_ff = PSRuntime(sess.spec, data=sess.data, timing=timing)
    ff = rt_ff.run(R)
    rt_cr = PSRuntime(sess.spec, data=sess.data, timing=timing,
                      faults=plan)
    cr = rt_cr.run(R)
    return rt_ff, ff, rt_cr, cr


def _rounds_gate(base, run, gate: str):
    """Rounds-to-tolerance of ``run`` against ``base`` (to the loss the
    base run reaches at 60% of its rounds): (base rounds, run rounds,
    their ratio, the gate's limit)."""
    R = base.num_rounds
    tol = base.losses[int(0.6 * R) - 1]
    r_base = _rounds_to_tolerance(base.losses, tol)
    r_run = _rounds_to_tolerance(run.losses, tol)
    ratio = float("inf") if r_run is None else r_run / r_base
    return r_base, r_run, ratio, _gate(gate)


def churn_scenario(emit: Emit, smoke: bool = False,
                   device: DeviceLike = None) -> bool:
    """Crash+rejoin at 8 workers, per-push commits, REAL numerics:
    deterministic plan, replay parity through the epoch (one device and
    the 8-rank SPMD mesh), and a rounds-to-tolerance gate — chaos must
    converge within ``max_churn_rounds_ratio`` x the fault-free round
    count."""
    ff, ch = churn_runs(smoke, device)
    r_ff, r_ch, ratio, max_ratio = _rounds_gate(
        ff, ch, "max_churn_rounds_ratio")
    emit(f"churn_faultfree_makespan,{ff.makespan*1e6:.0f},"
         f"rounds_to_tol={r_ff}")
    emit(f"churn_chaos_makespan,{ch.makespan*1e6:.0f},"
         f"rounds_to_tol={r_ch}")
    emit(f"churn_rounds_ratio,{ratio:.3f},max={max_ratio}"
         f"|crashes={ch.metrics['crashes']}|rejoins={ch.metrics['rejoins']}")
    _emit_hist(emit, "churn_worker_stall_hist",
               ch.metrics["histograms"]["worker_stall_time"])
    _emit_hist(emit, "churn_server_occupancy_hist",
               ch.metrics["histograms"]["server_occupancy"])

    # replay parity: the chaos trace (staleness + participation) must
    # reproduce the runtime's z trajectory through the epoch
    err = _replay_max_err(ch, build_session(
        delay_model=ch.to_delay_model(), device=device, **REPLAY_SESSION))
    emit(f"churn_replay_err_1dev,{err:.2e},tol=1e-05")
    spmd = spmd_replay_err(emit, "churn", ch, device)
    ok = err <= 1e-5 and spmd <= SPMD_TOL
    if ratio > max_ratio:
        emit(f"churn_gate_FAILED,0,rounds ratio {ratio:.3f} > {max_ratio}")
    if not ok:
        emit("churn_gate_FAILED,0,replay parity error above 1e-5")
    return ok and ratio <= max_ratio


def lossy_scenario(emit: Emit, smoke: bool = False,
                   device: DeviceLike = None) -> bool:
    """Unreliable transport at 8 workers, REAL numerics: 5% drop, 2%
    duplication, 10% reorder on every worker<->server link, with the
    ack/retry/backoff layer on. Gates rounds-to-tolerance lossy/reliable
    vs ``max_lossy_rounds_ratio`` and replay parity of the lossy trace
    (one device and the 8-rank SPMD mesh)."""
    rel, lo = lossy_runs(smoke, device)
    r_rel, r_lo, ratio, max_ratio = _rounds_gate(
        rel, lo, "max_lossy_rounds_ratio")
    t = lo.metrics["transport"]
    emit(f"lossy_reliable_makespan,{rel.makespan*1e6:.0f},"
         f"rounds_to_tol={r_rel}")
    emit(f"lossy_transport_makespan,{lo.makespan*1e6:.0f},"
         f"rounds_to_tol={r_lo}")
    emit(f"lossy_rounds_ratio,{ratio:.3f},max={max_ratio}"
         f"|delivery_rate={t['delivery_rate']:.3f}"
         f"|drops={t['drops']}|dups={t['dups']}|reorders={t['reorders']}"
         f"|retransmits={t['retransmits']}|dups_dropped={t['dups_dropped']}"
         f"|timeout_fallbacks={t['timeout_fallbacks']}")
    err = _replay_max_err(lo, build_session(
        delay_model=lo.to_delay_model(), device=device, **REPLAY_SESSION))
    emit(f"lossy_replay_err_1dev,{err:.2e},tol=1e-05")
    spmd = spmd_replay_err(emit, "lossy", lo, device)
    ok = err <= 1e-5 and spmd <= SPMD_TOL
    if ratio > max_ratio:
        emit(f"lossy_gate_FAILED,0,rounds ratio {ratio:.3f} > {max_ratio}")
    if not ok:
        emit("lossy_gate_FAILED,0,replay parity error above 1e-5")
    return ok and ratio <= max_ratio


def _per_round_folds(rt) -> list:
    """Per domain: {round: sorted [(worker, block)]} from its fold log
    (in-round order may differ across a recovery)."""
    out = []
    for dom in rt.domains:
        rounds: Dict[int, list] = {}
        for (t, i, j) in dom.fold_log:
            rounds.setdefault(t, []).append((i, j))
        out.append({t: sorted(f) for t, f in rounds.items()})
    return out


def lost_fold_rounds(rt_ff, rt_cr) -> int:
    """(domain, round) pairs whose fold multisets differ between the
    crash-free and the crash run: a lost or duplicated commit."""
    lost = 0
    for ff, cr in zip(_per_round_folds(rt_ff), _per_round_folds(rt_cr)):
        lost += sum(ff.get(t) != cr.get(t) for t in set(ff) | set(cr))
    return lost


def server_crash_scenario(emit: Emit, smoke: bool = False,
                          device: DeviceLike = None) -> bool:
    """Block-server crash + WAL-replay recovery at 8 real-compute
    workers: a deterministic ``server_crash`` plan drops two lock
    domains' in-memory state mid-run; each rebuilds from its write-ahead
    commit log. Gates (``ps_baseline.json``):

    * **zero lost folds** — every domain's committed fold log matches
      the crash-free run's per-round multiset exactly (hard-fail);
    * **rounds-to-tolerance** — the crash run must reach the crash-free
      tolerance within ``max_server_crash_rounds_ratio`` x its rounds
      (recovery costs sim time, never committed progress);
    * **replay parity** — the crash run's trace replays through the
      vectorized epoch within 1e-5 on one device and on the 8-rank SPMD
      mesh."""
    rt_ff, ff, rt_cr, cr = server_crash_runs(smoke, device)

    lost = lost_fold_rounds(rt_ff, rt_cr)
    # read the durability instruments straight off the run's metrics
    # registry (the same instruments PSRunResult.metrics is built from)
    m = rt_cr.registry.collect(["server_recoveries", "wal"])
    emit(f"server_crash_folds,{sum(len(d.fold_log) for d in rt_cr.domains)},"
         f"mismatched_rounds={lost}"
         f"|recoveries={m['server_recoveries']}"
         f"|wal_commits={m['wal']['commits']}"
         f"|wal_replays={m['wal']['replays']}")
    ok = lost == 0 and m["server_recoveries"] == 2 \
        and ff.metrics.get("server_recoveries", 0) == 0

    r_ff, r_cr, ratio, max_ratio = _rounds_gate(
        ff, cr, "max_server_crash_rounds_ratio")
    emit(f"server_crash_faultfree_makespan,{ff.makespan*1e6:.0f},"
         f"rounds_to_tol={r_ff}")
    emit(f"server_crash_chaos_makespan,{cr.makespan*1e6:.0f},"
         f"rounds_to_tol={r_cr}")
    emit(f"server_crash_rounds_ratio,{ratio:.3f},max={max_ratio}")

    err = _replay_max_err(cr, build_session(
        delay_model=cr.to_delay_model(), device=device, **REPLAY_SESSION))
    emit(f"server_crash_replay_err_1dev,{err:.2e},tol=1e-05")
    spmd = spmd_replay_err(emit, "server_crash", cr, device)
    ok = ok and err <= 1e-5 and spmd <= SPMD_TOL
    if lost:
        emit(f"server_crash_gate_FAILED,0,{lost} rounds lost/extra folds "
             f"after WAL replay")
    if ratio > max_ratio:
        emit(f"server_crash_gate_FAILED,0,rounds ratio {ratio:.3f} > "
             f"{max_ratio}")
    if not ok:
        emit("server_crash_gate_FAILED,0,replay parity or recovery "
             "count off")
    return ok and ratio <= max_ratio


def skew_scenario(emit: Emit, smoke: bool = False,
                  device: DeviceLike = None) -> bool:
    """Timing-only: zipf(a=1.5) vs uniform block selection at 8 workers
    under per-push commits (a domain's busy time follows its push
    count). Gated: the zipf run's occupancy spread (busiest/mean domain
    busy fraction) must exceed the uniform run's by
    ``min_skew_occupancy_ratio``."""
    R = 12 if smoke else 40
    timing = CostProfile(t_worker=ConstantService(1.0),
                         t_server_block=ConstantService(0.25),
                         t_push=0.05)
    spread = {}
    for selection in ("random", "zipf"):
        sess = build_session(GATE_WORKERS, dim=CHURN_DIM, samples=4,
                             block_selection=selection, zipf_a=1.5,
                             device=device)
        rt = PSRuntime(sess.spec, discipline="per_push", timing=timing,
                       compute="timing")
        res = rt.run(R)
        m = rt.registry.collect(["server_busy_frac", "histograms"])
        bf = m["server_busy_frac"]
        spread[selection] = max(bf) / (sum(bf) / len(bf))
        emit(f"skew_{selection}_makespan,{res.makespan*1e6:.0f},"
             f"busy_max={max(bf):.3f}|busy_min={min(bf):.3f}"
             f"|spread={spread[selection]:.3f}")
        _emit_hist(emit, f"skew_{selection}_occupancy_hist",
                   m["histograms"]["server_occupancy"])
    min_ratio = _gate("min_skew_occupancy_ratio")
    ratio = spread["zipf"] / spread["random"]
    emit(f"skew_spread_ratio,{ratio:.3f},min={min_ratio}")
    if ratio < min_ratio:
        emit(f"skew_gate_FAILED,0,zipf/random occupancy spread "
             f"{ratio:.3f} < {min_ratio}")
        return False
    return True


def heavy_tail_scenario(emit: Emit, smoke: bool = False,
                        device: DeviceLike = None) -> bool:
    """Timing-only: Pareto(alpha=1.1) worker compute under round-buffered
    vs per-push commits. Gated: the straggler tail must bite (lockfree
    stall time >= ``min_heavy_tail_stall``) while every served read
    stays within the enforced staleness bound."""
    R = 12 if smoke else 40
    timing = CostProfile(t_worker=ParetoService(1.0, alpha=1.1),
                         t_server_block=ConstantService(0.25))
    stalls = {}
    ok = True
    for disc in ("lockfree", "per_push"):
        sess = build_session(GATE_WORKERS, dim=CHURN_DIM, samples=4,
                             device=device)
        rt = PSRuntime(sess.spec, discipline=disc, timing=timing,
                       compute="timing")
        res = rt.run(R)
        m = rt.registry.collect(["stall_time", "max_served_tau", "bound",
                                 "histograms"])
        stalls[disc] = m["stall_time"]
        ok = ok and m["max_served_tau"] <= m["bound"]
        emit(f"heavy_tail_{disc}_makespan,{res.makespan*1e6:.0f},"
             f"stall_time={m['stall_time']:.2f}"
             f"|max_served_tau={m['max_served_tau']}")
        _emit_hist(emit, f"heavy_tail_{disc}_stall_hist",
                   m["histograms"]["worker_stall_time"])
    min_stall = _gate("min_heavy_tail_stall")
    emit(f"heavy_tail_lockfree_stall,{stalls['lockfree']:.2f},"
         f"min={min_stall}")
    if not ok:
        emit("heavy_tail_gate_FAILED,0,served tau above the bound")
        return False
    if stalls["lockfree"] < min_stall:
        emit(f"heavy_tail_gate_FAILED,0,lockfree stall time "
             f"{stalls['lockfree']:.2f} < {min_stall}")
        return False
    return True


SCENARIOS = {"churn": churn_scenario, "lossy": lossy_scenario,
             "server_crash": server_crash_scenario,
             "skew": skew_scenario, "heavy_tail": heavy_tail_scenario}


def main(emit: Emit = print, smoke: bool = False,
         device: DeviceLike = None) -> List[Dict]:
    """Measure the costs on ``device``, then Table 1 (``smoke``: the
    gate first, then a reduced sweep). Returns the Table 1 rows;
    raises ``SystemExit(1)`` when the smoke gate fails."""
    costs = measured_costs(device=device)
    emit(f"speedup_measured_costs,{costs['t_worker']*1e6:.1f},"
         f"t_serve_block_us={costs['t_server_block']*1e6:.1f}")
    if smoke:
        if not smoke_gate(emit, costs, device):
            raise SystemExit(1)
        return table1(emit, costs, workers=[1, GATE_WORKERS], k_iters=64,
                      device=device)
    return table1(emit, costs, device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="deterministic locked-vs-lockfree gate at 8 "
                         "workers + a reduced Table-1 sweep (or a reduced "
                         "scenario with --scenario)")
    ap.add_argument("--scenario", default=None, choices=sorted(SCENARIOS),
                    help="elastic-PS study instead of Table 1")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    if args.scenario is not None:
        if not SCENARIOS[args.scenario](print, smoke=args.smoke,
                                        device=args.device):
            raise SystemExit(1)
    else:
        main(smoke=args.smoke, device=args.device)
