"""Deterministic fault injection for the PS runtime.

A :class:`FaultPlan` is a declarative, JSON-serializable timeline of
chaos events; the :class:`FaultInjector` turns it into scheduler events
and service-time multipliers inside one ``PSRuntime.run``. Everything
is deterministic: event times are fixed by the plan, stochastic plan
*generation* (:meth:`FaultPlan.churn`) uses the runtime's seeded
per-entity rng convention (``np.random.default_rng([seed, tag])``), and
multipliers scale the draws the per-entity generators were already
making — so a chaos run is exactly as replayable as a fault-free one,
and its recorded :class:`~repro_torch.ps.trace.DelayTrace` (staleness +
participation) reproduces the z trajectory through ``asybadmm_epoch``.

Event kinds
-----------
``crash``        worker ``worker`` dies at sim time ``at``; with
                 ``duration`` it restarts after that much downtime
                 (membership resumes it at the service frontier),
                 without it stays down for good.
``leave``        permanent departure (sugar for a crash without
                 restart, recorded distinctly in the trace events).
``join``         ``worker`` is NOT in the initial fleet; it boots cold
                 at ``at`` and joins at the frontier. Join workers must
                 still be counted in the spec's N — they own edge rows;
                 membership just keeps them absent until activation.
``slowdown``     worker's compute service draws are multiplied by
                 ``factor`` during [at, at+duration) — a transient
                 straggler.
``server_spike`` commit-service draws of the lock domain holding block
                 ``block`` are multiplied by ``factor`` during
                 [at, at+duration) — a slow/hot server.
``link_loss``    a windowed loss burst: every message sent during
                 [at, at+duration) is dropped with probability
                 ``factor`` (composed with the Transport's base
                 drop_rate as ``1-(1-p)(1-q)``), scoped to worker
                 ``worker`` and/or the lock domain holding block
                 ``block`` when given, fleet-wide otherwise. A plan
                 with link_loss events engages the ack/retry transport
                 layer even when the base network is reliable.
``server_crash`` the lock domain holding block ``block`` LOSES its
                 volatile state at ``at`` (in-memory z versions,
                 caches, pending declarations/pushes, queued pulls)
                 and comes back after ``duration`` by replaying its
                 write-ahead commit log — zero committed folds lost.
                 The durability layer is not ported yet (ROADMAP
                 Queue A item 1): the runtime refuses a plan with
                 server_crash events. ``duration`` is required: a
                 server that never recovers would deadlock its commit
                 gates. Messages sent to a down server are dropped, so
                 a plan with server_crash events engages the ack/retry
                 transport layer like ``link_loss`` does.
"""
from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

FAULT_KINDS = ("crash", "leave", "join", "slowdown", "server_spike",
               "link_loss", "server_crash")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str
    at: float
    worker: Optional[int] = None
    block: Optional[int] = None
    duration: Optional[float] = None
    factor: Optional[float] = None

    def validate(self, num_workers: Optional[int] = None,
                 num_blocks: Optional[int] = None) -> "FaultEvent":
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {FAULT_KINDS}")
        if not np.isfinite(self.at) or self.at < 0.0:
            raise ValueError(f"fault time must be finite and >= 0; got "
                             f"at={self.at} for {self.kind}")
        needs_worker = self.kind in ("crash", "leave", "join", "slowdown")
        if needs_worker:
            if self.worker is None:
                raise ValueError(f"{self.kind} event needs a worker id")
            if num_workers is not None and not 0 <= self.worker < num_workers:
                raise ValueError(f"{self.kind} worker {self.worker} outside "
                                 f"[0, {num_workers})")
        if self.kind == "server_spike":
            if self.block is None:
                raise ValueError("server_spike event needs a block id")
            if num_blocks is not None and not 0 <= self.block < num_blocks:
                raise ValueError(f"server_spike block {self.block} outside "
                                 f"[0, {num_blocks})")
        if self.kind in ("slowdown", "server_spike"):
            if self.duration is None or self.duration <= 0.0:
                raise ValueError(f"{self.kind} needs duration > 0; got "
                                 f"{self.duration}")
            if self.factor is None or not np.isfinite(self.factor) \
                    or self.factor <= 0.0:
                raise ValueError(f"{self.kind} needs a finite factor > 0; "
                                 f"got {self.factor}")
        if self.kind == "link_loss":
            if self.duration is None or self.duration <= 0.0:
                raise ValueError(f"link_loss needs duration > 0; got "
                                 f"{self.duration}")
            if self.factor is None or not np.isfinite(self.factor) \
                    or not 0.0 < self.factor <= 1.0:
                raise ValueError(
                    f"link_loss factor is the window's drop probability "
                    f"and must be in (0, 1]; got {self.factor}")
            if self.worker is not None and num_workers is not None \
                    and not 0 <= self.worker < num_workers:
                raise ValueError(f"link_loss worker {self.worker} outside "
                                 f"[0, {num_workers})")
            if self.block is not None and num_blocks is not None \
                    and not 0 <= self.block < num_blocks:
                raise ValueError(f"link_loss block {self.block} outside "
                                 f"[0, {num_blocks})")
        if self.kind == "server_crash":
            if self.block is None:
                raise ValueError("server_crash event needs a block id (it "
                                 "scopes the lock domain holding that block)")
            if num_blocks is not None and not 0 <= self.block < num_blocks:
                raise ValueError(f"server_crash block {self.block} outside "
                                 f"[0, {num_blocks})")
            if self.duration is None or self.duration <= 0.0:
                raise ValueError(
                    f"server_crash needs duration > 0 (the recovery delay; "
                    f"a server that never recovers would deadlock its "
                    f"commit gates); got {self.duration}")
        if self.kind == "crash" and self.duration is not None \
                and self.duration <= 0.0:
            raise ValueError(f"crash downtime must be > 0 (or omitted for "
                             f"a permanent crash); got {self.duration}")
        return self

    def to_dict(self) -> Dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        evs = tuple(e if isinstance(e, FaultEvent) else FaultEvent(**e)
                    for e in self.events)
        object.__setattr__(self, "events", evs)

    def validate(self, num_workers: Optional[int] = None,
                 num_blocks: Optional[int] = None) -> "FaultPlan":
        for e in self.events:
            e.validate(num_workers, num_blocks)
        # one membership timeline per worker: a worker is either in the
        # initial fleet or a cold joiner, never both
        joiners = self.cold_workers
        for e in self.events:
            if e.kind == "join" and sum(
                    1 for x in self.events
                    if x.kind == "join" and x.worker == e.worker) > 1:
                raise ValueError(f"worker {e.worker} has multiple join "
                                 f"events; use crash+duration for churn")
        for e in self.events:
            if e.kind in ("crash", "leave") and e.worker in joiners \
                    and e.at <= min(x.at for x in self.events
                                    if x.kind == "join"
                                    and x.worker == e.worker):
                raise ValueError(f"worker {e.worker} crashes/leaves before "
                                 f"its join event")
        return self

    @property
    def has_link_loss(self) -> bool:
        """Whether any event is a link_loss burst — the runtime engages
        the unreliable-transport layer when so."""
        return any(e.kind == "link_loss" for e in self.events)

    @property
    def has_server_crash(self) -> bool:
        """Whether any event crashes a block server — the runtime then
        arms the per-domain write-ahead commit log (not ported yet:
        ``PSRuntime`` refuses such plans) and engages the ack/retry transport layer (messages to a down
        server are dropped and must retransmit)."""
        return any(e.kind == "server_crash" for e in self.events)

    @property
    def cold_workers(self) -> frozenset:
        """Workers that boot cold (join events) — excluded from the
        initial fleet by the runtime."""
        return frozenset(e.worker for e in self.events if e.kind == "join")

    # ---- construction helpers ---------------------------------------------
    @classmethod
    def of(cls, *events: FaultEvent) -> "FaultPlan":
        return cls(tuple(events)).validate()

    @staticmethod
    def crash(worker: int, at: float, down: Optional[float] = None
              ) -> FaultEvent:
        return FaultEvent("crash", at, worker=worker, duration=down)

    @staticmethod
    def leave(worker: int, at: float) -> FaultEvent:
        return FaultEvent("leave", at, worker=worker)

    @staticmethod
    def join(worker: int, at: float) -> FaultEvent:
        return FaultEvent("join", at, worker=worker)

    @staticmethod
    def slowdown(worker: int, at: float, duration: float, factor: float
                 ) -> FaultEvent:
        return FaultEvent("slowdown", at, worker=worker, duration=duration,
                          factor=factor)

    @staticmethod
    def server_spike(block: int, at: float, duration: float, factor: float
                     ) -> FaultEvent:
        return FaultEvent("server_spike", at, block=block, duration=duration,
                          factor=factor)

    @staticmethod
    def link_loss(at: float, duration: float, drop: float, *,
                  worker: Optional[int] = None,
                  block: Optional[int] = None) -> FaultEvent:
        """A loss burst: messages during [at, at+duration) drop with
        probability ``drop``, scoped to ``worker``'s links and/or the
        lock domain holding ``block`` when given."""
        return FaultEvent("link_loss", at, worker=worker, block=block,
                          duration=duration, factor=drop)

    @staticmethod
    def server_crash(block: int, at: float, down: float) -> FaultEvent:
        """The lock domain holding ``block`` loses its volatile state at
        ``at`` and recovers by WAL replay after ``down`` sim seconds."""
        return FaultEvent("server_crash", at, block=block, duration=down)

    @classmethod
    def churn(cls, num_workers: int, *, seed: int = 0, crashes: int = 2,
              window: Tuple[float, float] = (2.0, 10.0),
              down: Tuple[float, float] = (2.0, 6.0)) -> "FaultPlan":
        """A deterministic random crash+rejoin plan: ``crashes`` distinct
        workers crash at times ~ U(window) and restart after downtime
        ~ U(down). Draws come from the runtime's per-entity rng
        convention (``default_rng([seed, 77])``), so the same seed
        yields the same plan everywhere."""
        if crashes > num_workers:
            raise ValueError(f"cannot crash {crashes} of {num_workers} "
                             f"workers")
        rng = np.random.default_rng([seed, 77])
        victims = rng.choice(num_workers, size=crashes, replace=False)
        evs = []
        for i in victims:
            at = float(rng.uniform(*window))
            dt = float(rng.uniform(*down))
            evs.append(cls.crash(int(i), at, dt))
        return cls(tuple(evs)).validate(num_workers)

    # ---- persistence ------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"events": [e.to_dict() for e in self.events]},
                          indent=2)

    @classmethod
    def from_json(cls, text: str, *,
                  source: str = "<fault plan>") -> "FaultPlan":
        """Parse a fault-plan JSON document. Errors are actionable —
        they name the source (``FaultPlan.load`` passes the file path)
        and the offending event index instead of leaking a bare
        ``JSONDecodeError`` / ``KeyError`` / ``TypeError``."""
        def bad(problem, idx=None):
            where = f"event {idx}: " if idx is not None else ""
            return ValueError(
                f"FaultPlan: {source} is not a valid fault plan — "
                f"{where}{problem}. Expected "
                f'{{"events": [{{"kind": ..., "at": <sim time>, ...}}]}} '
                f"with kinds {FAULT_KINDS} (schema in API.md's elastic-PS "
                f"section).")

        try:
            obj = json.loads(text)
        except json.JSONDecodeError as e:
            raise bad(f"corrupt JSON ({e})") from e
        if not isinstance(obj, dict) \
                or not isinstance(obj.get("events", []), list):
            raise bad("top level must be an object with an 'events' list")
        events = []
        for idx, spec in enumerate(obj.get("events", [])):
            if not isinstance(spec, dict):
                raise bad(f"must be an object, got {type(spec).__name__}",
                          idx)
            try:
                ev = FaultEvent(**spec)
            except TypeError as e:
                raise bad(f"{e}; the only fields are kind, at, worker, "
                          f"block, duration, factor", idx) from e
            try:
                ev.validate()
            except (ValueError, TypeError) as e:
                raise bad(str(e), idx) from e
            events.append(ev)
        try:
            return cls(tuple(events)).validate()
        except ValueError as e:
            raise bad(str(e)) from e

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:          # FileNotFoundError names the path
            text = f.read()
        return cls.from_json(text, source=repr(path))


class FaultInjector:
    """Drives one runtime's chaos: schedules the plan's membership
    transitions and answers multiplier queries for service draws.

    The injector never touches numerics — it only moves membership
    state (through ``PSRuntime._crash_worker`` / ``_rejoin_worker``)
    and scales the durations the per-entity rngs already drew, so the
    recorded trace stays the single source of replay truth."""

    def __init__(self, plan: Optional[FaultPlan], runtime):
        self.plan = plan if plan is not None else FaultPlan()
        self.rt = runtime
        self.fired = set()                         # action keys already run
        self._worker_windows = defaultdict(list)   # i -> [(s, e, factor)]
        self._block_windows = defaultdict(list)    # j -> [(s, e, factor)]
        # [(s, e, drop_p, worker|None, block|None)] — queried per send
        self._link_windows = []
        for e in self.plan.events:
            if e.kind == "slowdown":
                self._worker_windows[e.worker].append(
                    (e.at, e.at + e.duration, e.factor))
            elif e.kind == "server_spike":
                self._block_windows[e.block].append(
                    (e.at, e.at + e.duration, e.factor))
            elif e.kind == "link_loss":
                self._link_windows.append(
                    (e.at, e.at + e.duration, e.factor, e.worker, e.block))

    def install(self, *, fired=(), floor: float = 0.0,
                log_windows: bool = True) -> None:
        """Schedule the plan's membership/server transitions (before
        t=0 worker starts, so same-time ties resolve plan-first —
        deterministically either way, by insertion seq). Every action
        is keyed ("<event idx>:<action>") and marks ``self.fired`` when
        it runs; a mid-run resume re-installs only the not-yet-fired
        actions (``fired=`` from the snapshot) at ``max(at, floor)``
        with ``floor`` = the restored clock. All actions carry the
        scheduler tag "fault" so the snapshot coordinator can tell
        pending chaos apart from in-flight work when it checks for
        quiescence."""
        sched = self.rt.sched
        self.fired = set(fired)

        def arm(key, at, fn):
            if key in self.fired:
                return

            def run():
                self.fired.add(key)
                fn()
            sched.at(max(at, floor), run, tag="fault")

        for idx, e in enumerate(self.plan.events):
            if e.kind in ("slowdown", "server_spike", "link_loss") \
                    and log_windows:
                # factor windows are queried, not scheduled — log them
                # into the trace timeline up front (a resumed run
                # restores the trace events instead of re-logging)
                self.rt.trace.add_event(e.kind, **{
                    k: v for k, v in e.to_dict().items() if k != "kind"})
            if e.kind == "crash":
                arm(f"{idx}:crash", e.at,
                    lambda i=e.worker: self.rt._crash_worker(i))
                if e.duration is not None:
                    arm(f"{idx}:rejoin", e.at + e.duration,
                        lambda i=e.worker: self.rt._rejoin_worker(i))
            elif e.kind == "leave":
                arm(f"{idx}:leave", e.at,
                    lambda i=e.worker: self.rt._crash_worker(
                        i, permanent=True))
            elif e.kind == "join":
                arm(f"{idx}:join", e.at,
                    lambda i=e.worker: self.rt._rejoin_worker(i, cold=True))
            elif e.kind == "server_crash":
                arm(f"{idx}:server_crash", e.at,
                    lambda j=e.block: self.rt._crash_server(j))
                arm(f"{idx}:server_recover", e.at + e.duration,
                    lambda j=e.block: self.rt._recover_server(j))

    # ---- multiplier queries -----------------------------------------------
    @staticmethod
    def _factor(windows, now: float) -> float:
        f = 1.0
        for (s, e, fac) in windows:
            if s <= now < e:
                f *= fac
        return f

    def worker_factor(self, i: int, now: float) -> float:
        """Compute-service multiplier for worker i at sim time ``now``."""
        w = self._worker_windows.get(i)
        return self._factor(w, now) if w else 1.0

    def server_factor(self, block_ids, now: float) -> float:
        """Commit-service multiplier for a lock domain holding
        ``block_ids`` at sim time ``now`` (spikes compose across the
        held blocks — a locked full-vector domain feels every spike)."""
        f = 1.0
        for j in block_ids:
            w = self._block_windows.get(j)
            if w:
                f *= self._factor(w, now)
        return f

    def link_drop(self, worker: int, block_ids, now: float) -> float:
        """Burst drop probability for a (worker, lock domain) link at
        sim time ``now``: overlapping windows compose as independent
        loss processes, ``1 - prod(1 - p_k)``. A window scoped to a
        worker/block applies only to links touching it; unscoped
        windows apply fleet-wide."""
        keep = 1.0
        for (s, e, p, w, b) in self._link_windows:
            if not s <= now < e:
                continue
            if w is not None and w != worker:
                continue
            if b is not None and b not in block_ids:
                continue
            keep *= 1.0 - p
        return 1.0 - keep

    @property
    def empty(self) -> bool:
        return not self.plan.events
