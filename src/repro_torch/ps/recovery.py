"""Durability + recovery for the PS runtime — the restartable service
(port of ``repro/ps/recovery.py``).

Two failure models, two mechanisms, one determinism contract:

**Block-server crash** (`server_crash` fault, :mod:`repro_torch.ps.chaos`).
Each lock domain armed for crashes owns a :class:`DomainWAL` — a
write-ahead commit log on simulated stable storage. Every declaration
(round intent + push payloads) is logged *before* any queue or commit
processing, and every committed version logs its fold order *before*
the version publish. A crash drops the server's volatile state — the
in-memory z version history, w~ caches, pending declarations/pushes,
queued pulls — and recovery rebuilds it exactly by replaying the log
through the same ``engine.apply_push`` / ``engine.commit_block`` fold
path the live server uses (on the card: the B2 kernel, once per
replayed block version), so the rebuilt contents are **bitwise** what
the crash-free fold produced:
zero committed folds lost. Uncommitted-but-logged declarations are
re-installed through the service queue in arrival order (the queue
itself was volatile, so its processing cost is re-paid — recovery
changes *timing*, never committed numerics). Messages sent to a down
server drop at the server, and the ack/retry transport layer's
retransmission recovers them — which is why a plan with
``server_crash`` events engages the transport layer like ``link_loss``
does.

**Whole-process kill** (``run_ps(checkpoint_every=, checkpoint_dir=,
resume_from=)``). The :class:`SnapshotCoordinator` takes a
crash-consistent snapshot of the *entire* runtime every
``checkpoint_every`` rounds using a quiescent barrier: workers park at
the top of each barrier round, and once every in-flight event has
drained (only the fault injector's future timeline remains queued —
the scheduler's ``only_tagged("fault")`` test) and no pull is parked
at the staleness enforcer, the full state — server version histories
and caches per domain, worker y/w/x, staleness counters, membership
intervals, every per-entity rng state, the DES clock, the partial
:class:`~repro_torch.ps.trace.DelayTrace`, per-round losses, and the fault
timeline's fired-set — is written atomically via
:mod:`repro_torch.checkpoint` (temp file + rename; a kill mid-save leaves
the previous snapshot intact). Parked workers are then released in
worker-id order at the barrier time.

Resume (``resume_from=``) rebuilds the runtime normally, restores the
clock and every piece of saved state, re-arms only the *not-yet-fired*
fault events (at ``max(at, clock)``), and schedules the parked
workers' releases exactly as the straight run's barrier did. Because
the barrier is part of the run's schedule, the contract is:

* a run with ``checkpoint_every=E`` killed after any snapshot and
  resumed from it produces a final z, z history, trace, fold log,
  losses and makespan **identical** (bitwise on either backend —
  restore feeds back the exact saved bytes) to the same run left
  uninterrupted;
* ``checkpoint_every=None`` is byte-identical to the pre-durability
  runtime (no barrier, no hook, no WAL unless ``server_crash`` faults
  arm it).

What is restored vs recomputed: the engine's per-round generators,
selection cache and minibatches, its edge columns and rho sums, and
the runtime's per-round data cache derive purely from the spec, the
seed and the round index, so they are recomputed, not stored;
everything stateful (rngs, clocks, counters, intervals, arrays) is
restored. The snapshot format is the reference's, key for key, so a
snapshot written by either package resumes in the other; arrays go to
the host through ``.detach().cpu()`` and come back with
``torch.as_tensor`` on the spec's device. Snapshots require a reliable
network (in-flight retransmission timers are not snapshotable) and
real compute; ``server_crash`` faults therefore do not compose with
``checkpoint_every`` — WAL recovery covers the server side, snapshots
cover the process side.
"""
from __future__ import annotations

import dataclasses
import weakref
import os
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint import load_arrays, load_extra, save

SNAPSHOT_FORMAT = "ps-snapshot-v1"
_PREFIX = "snap-"


# ---------------------------------------------------------------------------
# write-ahead commit log (per lock domain)
# ---------------------------------------------------------------------------

class DomainWAL:
    """Simulated stable storage for one lock domain.

    Two record streams, both append-only and idempotent:

    * **declare records** — keyed ``(worker, round)`` (the same dedup
      key the transport commit gate uses), holding the round's push
      payloads ``[(block, value)]`` in arrival order. Logged before the
      server touches its queue: write-ahead.
    * **commit records** — ``commits[v]`` is version v's fold order
      ``[(worker, block)]``, logged before the version publish. Replay
      walks them in order, looking each fold's payload up in the
      declare records, through the same engine fold path — bitwise.
    """

    def __init__(self, sid: int):
        self.sid = sid
        # (worker, round) -> [(block, value)], insertion = arrival order
        self._decls: Dict[Tuple[int, int], list] = {}
        self.commits: List[Tuple[Tuple[int, int], ...]] = []
        self.dedup_skips = 0
        self.replays = 0

    def record_declare(self, i: int, t: int, pushes: list) -> bool:
        """Append worker i's round-t declaration; a duplicate key is a
        no-op (the log is idempotent under retransmission)."""
        key = (i, t)
        if key in self._decls:
            self.dedup_skips += 1
            return False
        self._decls[key] = list(pushes)
        return True

    def record_commit(self, v: int, folds: list) -> None:
        """Append version v's fold order. Versions commit in sequence,
        so a redone commit (the in-flight one a crash stranded) lands
        exactly where the lost attempt would have."""
        if v != len(self.commits):
            raise RuntimeError(
                f"WAL commit record out of sequence: version {v} logged "
                f"with {len(self.commits)} commits on record")
        self.commits.append(tuple((i, j) for (i, j) in folds))

    def value(self, i: int, t: int, j: int):
        """The logged push payload for (worker i, round t, block j)."""
        for (jj, value) in self._decls[(i, t)]:
            if jj == j:
                return value
        raise KeyError(f"WAL has no push for worker {i} round {t} "
                       f"block {j}")

    def pending(self, version: int):
        """Declarations for rounds >= ``version`` (not yet folded into
        a committed version), in arrival order — what recovery
        re-installs through the service queue."""
        return [(i, t, list(pushes))
                for (i, t), pushes in self._decls.items() if t >= version]

    @property
    def declares(self) -> int:
        return len(self._decls)


def register_wal_metrics(reg, domains) -> None:
    """Register the durability instruments (WAL record totals +
    recovery count) over the run's armed lock domains."""
    reg.counter("server_recoveries",
                lambda: sum(d.recoveries for d in domains))
    reg.gauge("wal", lambda: {
        "commits": sum(len(d.wal.commits) for d in domains),
        "declares": sum(d.wal.declares for d in domains),
        "dedup_skips": sum(d.wal.dedup_skips for d in domains),
        "replays": sum(d.wal.replays for d in domains)})


# ---------------------------------------------------------------------------
# crash-consistent snapshots (quiescent barrier)
# ---------------------------------------------------------------------------

class SnapshotCoordinator:
    """Parks workers at rounds E, 2E, ... and writes one atomic
    snapshot per barrier once the runtime is quiescent.

    Quiescence = every alive, unfinished worker is parked AND the
    scheduler's queue holds only the fault injector's future timeline
    AND no pull is parked at the staleness enforcer — i.e. nothing is
    in flight, so the state on the heap IS the state of the run. The
    check runs from the scheduler's ``after_event`` hook; parked
    workers are released in worker-id order at the barrier time, which
    makes the barrier a deterministic part of the run's schedule (a
    resumed run re-creates the identical releases)."""

    def __init__(self, runtime, every: int, directory: str):
        self.rt = weakref.proxy(runtime)   # the runtime owns it: no cycle
        self.every = int(every)
        self.dir = str(directory)
        self.next_round = self.every
        self.parked: Dict[int, int] = {}     # worker id -> parked round
        self.written: List[str] = []
        # telemetry anchor: sim time the first worker parked at the
        # pending barrier (the "snapshot" span's start)
        self._barrier_start: Optional[float] = None

    @property
    def active(self) -> bool:
        """Barriers land strictly inside the horizon — a final-round
        snapshot would duplicate the run's own result."""
        return self.next_round < self.rt.num_rounds

    def park(self, wk, t: int) -> bool:
        """Worker ``wk`` is entering round t; park it when the round is
        at/past the next barrier. Returns True when parked (the worker
        resumes via the barrier's release)."""
        if not self.active or t < self.next_round:
            return False
        if self._barrier_start is None:
            self._barrier_start = self.rt.sched.now
        self.parked[wk.i] = t
        return True

    def unpark(self, i: int) -> None:
        """Worker i crashed while parked — it no longer blocks (or
        rides) the barrier; membership already marked it absent."""
        self.parked.pop(i, None)

    def check(self) -> None:
        """The scheduler's after-event hook: fire the barrier once the
        runtime is quiescent."""
        if not self.active:
            return
        rt = self.rt
        for wk in rt._workers:
            if wk.alive and wk.t < rt.num_rounds and wk.i not in self.parked:
                return
        if not rt.sched.only_tagged("fault"):
            return
        if not rt.enforcer.idle:
            return
        self._fire()

    def _fire(self) -> None:
        rt = self.rt
        self.written.append(
            write_snapshot(rt, self.dir, self.next_round, self.parked))
        obs = rt.obs
        if obs is not None and obs.spans is not None:
            start = self._barrier_start if self._barrier_start is not None \
                else rt.sched.now
            obs.spans.complete(obs.RUNTIME_TRACK, "snapshot",
                               start, rt.sched.now,
                               round=self.next_round,
                               path=self.written[-1],
                               parked=len(self.parked))
        self._barrier_start = None
        self.next_round += self.every
        parked, self.parked = self.parked, {}
        for i in sorted(parked):
            wk = rt._workers[i]
            rt.sched.at(rt.sched.now, wk._guarded(
                lambda wk=wk, t=parked[i]: wk._begin_round(t)))

    def register_metrics(self, reg) -> None:
        reg.gauge("snapshots", lambda: list(self.written))


# ---------------------------------------------------------------------------
# snapshot serialization
# ---------------------------------------------------------------------------

def snapshot_path(directory: str, round_: int) -> str:
    return os.path.join(directory, f"{_PREFIX}{int(round_):06d}")


def list_snapshots(directory: str) -> List[str]:
    """Snapshot path prefixes in ``directory``, oldest round first."""
    out = []
    for name in sorted(os.listdir(directory)):
        if name.startswith(_PREFIX) and name.endswith(".json"):
            out.append(os.path.join(directory, name[:-len(".json")]))
    return out


def latest_snapshot(directory: str) -> Optional[str]:
    snaps = list_snapshots(directory)
    return snaps[-1] if snaps else None


def _host(t) -> np.ndarray:
    """A device tensor's bytes as a host numpy array."""
    return t.detach().cpu().numpy()


def _fingerprint(rt) -> Dict[str, Any]:
    """The run-shape identity a snapshot is only valid against."""
    eng = rt.engine
    return {
        "space": type(eng.space).__name__,
        "workers": int(eng.N),
        "blocks": int(eng.M),
        "num_rounds": int(rt.num_rounds),
        "discipline": rt.discipline,
        "seed": int(rt.seed),
        "bound": int(rt.bound),
        "record_z": bool(rt.record_z),
        "minibatch": rt.spec.minibatch,
        "checkpoint_every": rt.ckpt.every if rt.ckpt is not None else None,
    }


def write_snapshot(rt, directory: str, round_: int,
                   parked: Dict[int, int]) -> str:
    """Serialize the quiescent runtime. Arrays go into the npz half,
    everything else (rng states, clocks, counters, intervals, the fault
    timeline's fired-set) into the manifest's ``extra`` blob; both land
    atomically via :func:`repro_torch.checkpoint.save`."""
    arrays: Dict[str, Any] = {"trace/delays": np.array(rt.trace.delays)}
    if not rt.timing_only:
        arrays["state/y"] = _host(rt.y)
        arrays["state/w"] = _host(rt.w)
        if rt.x is not None:
            arrays["state/x"] = _host(rt.x)
    domains_meta = []
    for dom in rt.domains:
        versions = {}
        for j in dom.block_ids:
            store = dom.contents.get(j, {})
            for v, arr in store.items():
                arrays[f"dom{dom.sid}/content/{j}/{v}"] = _host(arr)
            versions[str(j)] = sorted(store)
            if j in dom.caches:
                arrays[f"dom{dom.sid}/cache/{j}"] = _host(dom.caches[j])
        domains_meta.append({
            "sid": dom.sid, "version": dom.version,
            "busy_until": dom.busy_until, "busy_time": dom.busy_time,
            "wait_time": dom.wait_time, "wait_count": dom.wait_count,
            "commits": dom.commits, "pushes": dom.pushes,
            "content_versions": versions,
            "fold_log": [list(e) for e in dom.fold_log],
            "rng": dom.rng.bit_generator.state,
        })
    workers_meta = [{
        "i": wk.i, "t": wk.t, "alive": wk.alive, "gen": wk.gen,
        "rounds_done": wk.rounds_done, "parked": wk.i in parked,
        "rng": wk.rng.bit_generator.state,
    } for wk in rt._workers]
    enf = rt.enforcer
    meta = {
        "format": SNAPSHOT_FORMAT,
        "round": int(round_),
        "clock": float(rt.sched.now),
        "fingerprint": _fingerprint(rt),
        "workers": workers_meta,
        "domains": domains_meta,
        "enforcer": {
            "pulls_served": enf.pulls_served,
            "max_served_tau": enf.max_served_tau,
            "stall_count": enf.stall_count,
            "stall_time": enf.stall_time,
            "dropped_pulls": enf.dropped_pulls,
            "version_resets": enf.version_resets,
            "timeout_fallbacks": enf.timeout_fallbacks,
            "stall_time_by_worker": dict(enf.stall_time_by_worker),
            "stall_count_by_worker": dict(enf.stall_count_by_worker),
        },
        "membership": rt.membership.state_dict(),
        "losses": rt._losses,
        "trace_events": rt.trace.events,
        "injector_fired": sorted(rt.injector.fired),
    }
    prefix = snapshot_path(directory, round_)
    save(prefix, arrays, step=int(round_), extra=meta)
    return prefix


@dataclasses.dataclass
class SnapshotState:
    """A loaded, format-validated snapshot ready for :func:`resume`."""
    path: str
    meta: Dict[str, Any]
    arrays: Dict[str, np.ndarray]


def load_snapshot(path: str) -> SnapshotState:
    """Load a snapshot by path prefix, ``.json``/``.npz`` half, or the
    checkpoint directory (resolves to the latest snapshot)."""
    path = os.fspath(path)
    if os.path.isdir(path):
        latest = latest_snapshot(path)
        if latest is None:
            raise FileNotFoundError(
                f"no PS snapshots ({_PREFIX}NNNNNN.json) in directory "
                f"{path!r} — nothing to resume from")
        path = latest
    if path.endswith(".json") or path.endswith(".npz"):
        path = path[:path.rfind(".")]
    meta = load_extra(path)
    fmt = meta.get("format") if isinstance(meta, dict) else None
    if fmt != SNAPSHOT_FORMAT:
        raise ValueError(
            f"{path!r} is not a PS runtime snapshot (manifest extra "
            f"format={fmt!r}, expected {SNAPSHOT_FORMAT!r}) — point "
            f"resume_from at a snapshot written by "
            f"run_ps(checkpoint_every=...)")
    return SnapshotState(path=path, meta=meta, arrays=load_arrays(path))


def resume(rt, snap: SnapshotState) -> None:
    """Restore a constructed-but-unlaunched runtime to the snapshot's
    quiescent barrier and arm it: clock, every entity's state and rng,
    the not-yet-fired fault timeline, and the parked workers' releases.
    The caller (``PSRuntime.run``) skips its normal t=0 launch. Arrays
    come back as tensors on the spec's device, byte for byte."""
    meta, arrays = snap.meta, snap.arrays
    dev = rt.engine.device

    def tensor(key):
        return torch.as_tensor(arrays[key], device=dev)
    current = _fingerprint(rt)
    saved = meta.get("fingerprint", {})
    diffs = [f"{k}: snapshot={saved.get(k)!r} vs run={current[k]!r}"
             for k in current if saved.get(k) != current[k]]
    if diffs:
        raise ValueError(
            f"snapshot {snap.path!r} was taken from a different run "
            f"configuration — resume requires the identical session "
            f"and run_ps arguments. Mismatched: {'; '.join(diffs)}")
    sched = rt.sched
    sched.restore_clock(meta["clock"])
    # chaos timeline first (smaller seqs), so same-time ties against
    # the releases pop in the straight run's order
    rt.injector.install(fired=meta["injector_fired"], floor=sched.now,
                        log_windows=False)
    for wmeta in meta["workers"]:
        wk = rt._workers[wmeta["i"]]
        wk.t = wmeta["t"]
        wk.alive = wmeta["alive"]
        wk.gen = wmeta["gen"]
        wk.rounds_done = wmeta["rounds_done"]
        wk.rng.bit_generator.state = wmeta["rng"]
    for dmeta in meta["domains"]:
        dom = rt.domains[dmeta["sid"]]
        dom.version = dmeta["version"]
        dom.busy_until = dmeta["busy_until"]
        dom.busy_time = dmeta["busy_time"]
        dom.wait_time = dmeta["wait_time"]
        dom.wait_count = dmeta["wait_count"]
        dom.commits = dmeta["commits"]
        dom.pushes = dmeta["pushes"]
        dom.fold_log = [tuple(e) for e in dmeta["fold_log"]]
        dom.rng.bit_generator.state = dmeta["rng"]
        if not rt.timing_only:
            dom.contents = {j: {} for j in dom.block_ids}
            dom.caches = {}
            for j in dom.block_ids:
                for v in dmeta["content_versions"][str(j)]:
                    dom.contents[j][int(v)] = tensor(
                        f"dom{dom.sid}/content/{j}/{v}")
                dom.caches[j] = tensor(f"dom{dom.sid}/cache/{j}")
    if not rt.timing_only:
        rt.y = tensor("state/y")
        rt.w = tensor("state/w")
        if "state/x" in arrays:
            rt.x = tensor("state/x")
    e = meta["enforcer"]
    enf = rt.enforcer
    enf.pulls_served = e["pulls_served"]
    enf.max_served_tau = e["max_served_tau"]
    enf.stall_count = e["stall_count"]
    enf.stall_time = e["stall_time"]
    enf.dropped_pulls = e["dropped_pulls"]
    enf.version_resets = e["version_resets"]
    enf.timeout_fallbacks = e["timeout_fallbacks"]
    enf.stall_time_by_worker = defaultdict(
        float, {int(k): v for k, v in e["stall_time_by_worker"].items()})
    enf.stall_count_by_worker = defaultdict(
        int, {int(k): v for k, v in e["stall_count_by_worker"].items()})
    rt.membership.restore_state(meta["membership"])
    rt.trace.delays = np.asarray(arrays["trace/delays"], np.int32)
    rt.trace.events = list(meta["trace_events"])
    if rt._losses is not None:
        rt._losses = [list(l) for l in meta["losses"]]
    if rt.ckpt is not None:
        rt.ckpt.next_round = meta["round"] + rt.ckpt.every
    # the straight run's barrier released parked workers in worker-id
    # order at the barrier time; re-create exactly those events
    for wmeta in meta["workers"]:
        if wmeta["parked"] and wmeta["alive"]:
            wk = rt._workers[wmeta["i"]]
            sched.at(sched.now, wk._guarded(
                lambda wk=wk, t=wmeta["t"]: wk._begin_round(t)))
