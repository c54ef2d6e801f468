"""Block servers — lock-free per-block vs locked full-vector (paper §1).

The paper's headline architectural claim is that block-wise servers
need NO global lock: a push to block j occupies only server j, so
different blocks commit concurrently, while all prior async consensus
ADMM (Chang et al. 2015; Zhang & Kwok 2014) serializes every update
through one full-vector lock. All disciplines here are the SAME server
implementation grouped (and commit-scheduled) differently:

* ``lockfree`` — M lock domains, one block each; round-buffered: the
  round's pushes apply and the block proxes once, at the round-v
  commit, paying one commit service time;
* ``locked``   — ONE lock domain holding every block; all pushes queue
  on it and each commit pays the per-block service time M times, under
  the lock;
* ``per_push`` — M per-block domains with **per-push commits**: the
  server does its fold/prox work eagerly as each push is processed
  through the queue (each push pays ``push_cost`` + one commit-service
  draw), so the round-boundary version *publish* is a pointer bump —
  free when the round folded at least one push, one commit-service
  draw for push-less (prox-only) rounds. The commit *fold* is the same
  round-ordered application lockfree does (given the same pushes, the
  published version is bit-identical), but the commit latency moves
  off the round boundary into the push stream — versions publish at
  different sim times, workers observe different staleness, and the
  run explores a different (still deterministic, still
  replay-exact) trajectory than lockfree. That timing shift is the
  point: fewer round-boundary stalls when declarations arrive spread
  out, longer queues on hot blocks under skew.

A lock domain commits version v+1 of its blocks once (a) it has heard
a round-v declaration (push or skip) from every worker in its edge
neighborhood that is ACTIVE for round v (elastic membership: crashed /
departed / not-yet-joined workers are excluded, so churn never
deadlocks a gate), (b) all round-v pushes have been processed through
its queue, and (c) version v is committed. Pushes that arrive EARLY (a
worker running up to T rounds ahead under bounded staleness) buffer
per round and apply to the stale-w~ cache only at their round's commit
— that round-ordering is what makes a recorded trace replay through
the vectorized epoch exactly. Commits cap at ``num_rounds``: versions
beyond the horizon would never be read.

``DISCIPLINES`` maps names to :class:`Discipline` entries (a block ->
lock-domain grouping plus the commit mode); register custom groupings
(e.g. shard-pair servers) with :func:`register_discipline`. Block ids
follow the packed block layout's contract: block j is row j of the
canonical (M, dblk) table.

The reference's durability layer (a per-domain write-ahead commit log
that rebuilds a crashed server) is not ported yet (ROADMAP Queue A
item 1); the runtime refuses ``server_crash`` faults until it is.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# coordination disciplines = block -> lock-domain groupings + commit mode
# ---------------------------------------------------------------------------

DisciplineFn = Callable[[int], List[Tuple[int, ...]]]


@dataclasses.dataclass(frozen=True)
class Discipline:
    """A named coordination discipline: how blocks group into lock
    domains (``groups(num_blocks)``) and whether commit work is paid
    per push (eager) or per round (buffered)."""
    groups: DisciplineFn
    per_push: bool = False


DISCIPLINES: Dict[str, Discipline] = {}


def register_discipline(name: str, *, per_push: bool = False):
    """Register a grouping fn under ``name``. The decorated callable
    keeps its plain ``fn(num_blocks) -> groups`` signature (existing
    custom registrations stay valid); ``per_push=True`` marks the
    discipline's commit work as paid eagerly per push."""
    def deco(fn: DisciplineFn) -> DisciplineFn:
        DISCIPLINES[name] = Discipline(fn, per_push)
        return fn
    return deco


@register_discipline("lockfree")
def lockfree_domains(num_blocks: int) -> List[Tuple[int, ...]]:
    """AsyBADMM: one lock domain per block server."""
    return [(j,) for j in range(num_blocks)]


@register_discipline("locked")
def locked_domains(num_blocks: int) -> List[Tuple[int, ...]]:
    """The baseline the paper beats: one global full-vector lock."""
    return [tuple(range(num_blocks))]


@register_discipline("per_push", per_push=True)
def per_push_domains(num_blocks: int) -> List[Tuple[int, ...]]:
    """Per-block servers with eager (per-push) commit work."""
    return [(j,) for j in range(num_blocks)]


def resolve_discipline(name: str) -> Discipline:
    try:
        return DISCIPLINES[name]
    except KeyError:
        raise ValueError(f"unknown discipline {name!r}; registered: "
                         f"{sorted(DISCIPLINES)}") from None


# ---------------------------------------------------------------------------
# the server process
# ---------------------------------------------------------------------------

class BlockServerProc:
    """One lock domain: a set of blocks sharing a serial service queue.

    Owns the blocks' committed-version contents, their stale-w~ caches,
    per-round push buffers and declarations; numeric commits delegate
    to ``engine.commit_block`` (the real server update)."""

    def __init__(self, sid: int, block_ids: Sequence[int], *, engine, sched,
                 enforcer, commit_service, push_cost: float,
                 rng: np.random.Generator, num_rounds: int,
                 edge_workers: frozenset, contents0: dict, caches0: dict,
                 timing_only: bool, per_push: bool = False,
                 membership=None, fault_factor=None, runtime=None):
        self.sid = sid
        self.block_ids = tuple(block_ids)
        self.engine = engine
        self.sched = sched
        self.enforcer = enforcer
        self.commit_service = commit_service
        self.push_cost = float(push_cost)
        self.rng = rng
        self.num_rounds = num_rounds
        self.edge_workers = edge_workers
        self.timing_only = timing_only
        self.per_push = per_push
        self.membership = membership
        # chaos hook: commit-latency multiplier at a sim time
        self._fault_factor = fault_factor
        # unreliable-transport state (None/unused on reliable runs):
        # the owning runtime (for routing responses/acks back through
        # its fabric), per-(worker, round) pull dedup and dup counter
        self.rt = runtime
        self._pull_state: Dict[Tuple[int, int], Optional[int]] = {}
        self.dups_dropped = 0
        # the exactly-once fold log ((version, worker, block) in fold
        # order) the transport/recovery property tests pin
        self.fold_log: list = []

        self.version = 0
        # contents[j][v] = block j's committed content at version v
        # (a dict keyed by version: old versions are prunable once no
        # worker can legally read them — see ``prune``)
        self.contents = {j: {0: contents0[j]} for j in self.block_ids} \
            if not timing_only else {}
        self.caches = dict(caches0) if not timing_only else {}
        self._decl: Dict[int, set] = defaultdict(set)
        self._push_buf: Dict[int, list] = defaultdict(list)
        self._unprocessed: Dict[int, int] = defaultdict(int)
        self._committing = False
        self.busy_until = 0.0
        self.busy_time = 0.0
        self.wait_time = 0.0
        self.wait_count = 0
        self.commits = 0
        self.pushes = 0

    # ---- queue occupancy --------------------------------------------------
    def _occupy(self, duration: float, label: Optional[str] = None) -> float:
        """Serialize ``duration`` of work through this lock domain's
        queue; returns the completion time. Accounts the queueing delay
        of the newly enqueued item (time it sat behind earlier work).
        ``label`` names the service span ("push_service" /
        "commit_service") on the telemetry track — purely a recording
        of the times computed here, never an input to them."""
        start = max(self.sched.now, self.busy_until)
        done = start + duration
        self.wait_time += start - self.sched.now
        self.wait_count += 1
        self.busy_until = done
        self.busy_time += duration
        obs = self.rt.obs if self.rt is not None else None
        if obs is not None and obs.spans is not None and label is not None:
            track = obs.server_track(self.sid)
            if start > self.sched.now:
                obs.spans.complete(track, "queue_wait",
                                   self.sched.now, start)
            if duration > 0:
                obs.spans.complete(track, label, start, done)
        return done

    def _commit_sample(self) -> float:
        dur = self.commit_service.sample(self.rng)
        if self._fault_factor is not None:
            dur *= self._fault_factor(self.block_ids, self.sched.now)
        return dur

    # ---- worker-facing API ------------------------------------------------
    def on_declare(self, i: int, t: int, pushes: list) -> None:
        """Worker i's round-t declaration: ``pushes`` is the
        [(block_id, w_value)] it commits this round (w_value is None in
        timing-only mode); an empty list is a skip. Either way the
        server now knows worker i's round-t intent — the runtime
        analogue of the bounded-delay assumption that lets a real
        lock-free server stop waiting on non-pushers."""
        self._decl[t].add(i)
        for (j, value) in pushes:
            self.pushes += 1
            self._unprocessed[t] += 1
            # per-push discipline: the server folds/proxes eagerly as it
            # processes the push, so the commit-service draw is paid
            # HERE instead of at the round-boundary publish
            cost = self.push_cost
            if self.per_push:
                cost += self._commit_sample()
            done = self._occupy(cost, label="push_service")
            self.sched.at(done, lambda t=t, i=i, j=j, v=value:
                          self._push_processed(t, i, j, v))
        self._maybe_commit()

    def _push_processed(self, t: int, i: int, j: int, value) -> None:
        self._push_buf[t].append((i, j, value))
        self._unprocessed[t] -= 1
        self._maybe_commit()

    # ---- unreliable-transport endpoints -----------------------------------
    # Only reachable when the runtime routes messages through a lossy
    # Transport; reliable runs never enter these paths.

    def on_pull_request(self, i: int, t: int) -> None:
        """Worker i's round-t pull REQUEST arrived over the lossy link.
        The served version is fixed exactly once per (worker, round) —
        a retransmitted request whose original is still pending is
        dropped (the pending resolution will answer both), and one
        whose response was already sent gets the SAME version resent
        (the response, not the request, must have been lost)."""
        key = (i, t)
        if key in self._pull_state:
            self.dups_dropped += 1
            v = self._pull_state[key]
            if v is not None:
                self._send_pull_response(i, t, v)
            return
        self._pull_state[key] = None       # pending at the enforcer
        self.enforcer.request(
            self, t, self.sched.now,
            lambda version, i=i, t=t: self._pull_served(i, t, version),
            worker=i)

    def _pull_served(self, i: int, t: int, version: int) -> None:
        self._pull_state[(i, t)] = version
        self._send_pull_response(i, t, version)

    def _send_pull_response(self, i: int, t: int, version: int) -> None:
        # the response carries the block payloads (as a real protocol
        # does)
        wk = self.rt.worker_proc(i)
        payload = None if self.timing_only else \
            [self.content_at(j, version) for j in self.block_ids]
        self.rt.fabric.link(i, self).send(
            lambda: wk.on_pull_response(self, t, version, payload),
            msg="pull_resp", t=t)

    def forget_pending_pulls(self, i: int) -> None:
        """Worker i crashed: its pending pull requests died with it (the
        enforcer already dropped the parked resolutions). Clearing the
        dedup state lets the revived incarnation's re-request for the
        same round be treated as NEW instead of an eternal duplicate."""
        for key in [k for k, v in self._pull_state.items()
                    if k[0] == i and v is None]:
            del self._pull_state[key]

    def on_declare_msg(self, i: int, t: int, pushes: list) -> None:
        """Worker i's round-t declaration bundle arrived over the lossy
        link. The commit gate dedups by (worker, round): a bundle for an
        already-committed round (t < version) or one already declared
        this round folds ZERO more times — but is re-acked either way,
        because a duplicate here usually means the original ack was
        lost and the worker is still retransmitting."""
        if t < self.version or i in self._decl[t]:
            self.dups_dropped += 1
        else:
            self.on_declare(i, t, pushes)
        self._send_ack(i, t)

    def _send_ack(self, i: int, t: int) -> None:
        wk = self.rt.worker_proc(i)
        self.rt.fabric.link(i, self).send(
            lambda: wk.on_declare_ack(self, t), msg="ack", t=t)

    # ---- commit machinery -------------------------------------------------
    def _required_declarations(self, v: int) -> frozenset:
        """Who round v's gate waits on: the edge neighborhood, minus
        workers elastic membership marks absent for round v."""
        if self.membership is None:
            return self.edge_workers
        return frozenset(i for i in self.edge_workers
                         if self.membership.required(i, v))

    def _maybe_commit(self) -> None:
        v = self.version
        if self._committing or v >= self.num_rounds:
            return
        if not self._decl[v] >= self._required_declarations(v):
            return
        if self._unprocessed[v] > 0:
            return
        self._committing = True
        if self.per_push:
            # commit work was paid per push; the version publish is a
            # pointer bump — unless the round folded nothing (prox-only
            # decay still runs the server update once)
            dur = 0.0 if self._push_buf.get(v) else self._commit_sample()
        else:
            dur = sum(self._commit_sample() for _ in self.block_ids)
        self.sched.at(self._occupy(dur, label="commit_service"),
                      self._finish_commit)

    def _finish_commit(self) -> None:
        v = self.version
        # apply round-v pushes to the stale-w~ caches in processed order
        # (round-buffered: early pushes from workers running ahead under
        # bounded staleness must not leak into this commit; per_push
        # pays its commit latency eagerly but folds at the SAME point,
        # so the published version is bit-identical across disciplines)
        pushes = self._push_buf.pop(v, [])
        self.fold_log.extend((v, i, j) for (i, j, _) in pushes)
        if not self.timing_only:
            for (i, j, value) in pushes:
                self.caches[j] = self.engine.apply_push(self.caches[j], i,
                                                        value)
            for j in self.block_ids:
                self.contents[j][v + 1] = self.engine.commit_block(
                    j, self.contents[j][v], self.caches[j])
            if self.rt is not None and self.rt.check_finite:
                for j in self.block_ids:
                    if not bool(torch.isfinite(
                            self.contents[j][v + 1]).all()):
                        raise FloatingPointError(
                            f"divergence watchdog: committed z for block "
                            f"{j} at round {v} (version {v + 1}) contains "
                            f"NaN/Inf — the run is training on garbage. "
                            f"Check rho / step sizes; rerun with "
                            f"check_finite=False to disable this halt.")
        self.version = v + 1
        self.commits += 1
        self._decl.pop(v, None)
        self._unprocessed.pop(v, None)
        self._committing = False
        obs = self.rt.obs if self.rt is not None else None
        if obs is not None:
            if obs.spans is not None:
                obs.spans.instant(obs.server_track(self.sid), "commit",
                                  self.sched.now, version=self.version,
                                  folds=len(pushes))
            # round-completion detection: the stream record for round
            # v emits the moment the LAST domain publishes version v+1
            obs.note_commit(self.sid, self.version, self.sched.now)
        self.enforcer.notify(self, self.sched.now)
        self._maybe_commit()

    # ---- reads ------------------------------------------------------------
    def content_at(self, j: int, version: int):
        return self.contents[j][version]

    def prune(self, min_version: int) -> None:
        """Drop committed versions below ``min_version`` (the oldest any
        worker can still legally read: min worker round - T). The
        newest version always stays. Keeps a real-compute run's memory
        at O(T) versions instead of O(num_rounds) when the caller does
        not want the full z trajectory."""
        for j in self.block_ids:
            store = self.contents[j]
            for v in [v for v in store if v < min_version
                      and v != self.version]:
                del store[v]

    # ---- telemetry --------------------------------------------------------
    @staticmethod
    def register_metrics(reg, domains: list, sched) -> None:
        """Register the server-side instruments over ``domains``
        (fleet totals + per-domain occupancy lists) into the run's
        :class:`~repro_torch.obs.MetricsRegistry`."""
        reg.counter("commits", lambda: sum(d.commits for d in domains))
        reg.counter("pushes", lambda: sum(d.pushes for d in domains))
        reg.gauge("server_busy_time",
                  lambda: [d.busy_time for d in domains])
        reg.gauge("server_busy_frac",
                  lambda: [d.busy_time / sched.now if sched.now > 0
                           else 0.0 for d in domains])
        reg.gauge("server_wait_time",
                  lambda: [d.wait_time for d in domains])
