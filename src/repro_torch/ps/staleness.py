"""Bounded-staleness enforcement (Assumption 3) for the PS runtime.

The theory requires every read z~_j = z_j^{t - tau} to satisfy
``tau <= T``. The vectorized epoch gets this for free (the delay model
draws within the ring depth); a real parameter server does NOT — a
straggling block server can fall arbitrarily far behind a fast worker.
The enforcer is the runtime's gatekeeper: a pull whose freshest
available version would violate the bound **stalls** (the worker
blocks, simulated time passes) until the server commits version
``t - T``, instead of silently clipping the staleness the way a
sampled delay model would.

Serving discipline, for determinism: waiters resolve in FIFO order
inside the commit event that satisfies them. Every served pull is
asserted ``0 <= tau <= T`` — the property tests/test_ps_runtime.py
sweeps disciplines and straggler models against.

Elasticity (chaos runs): a crashed worker's parked pulls are dropped
(:meth:`drop_worker` — they will never be consumed), and a rejoin is
accounted as a **version reset**, not a tau violation: the membership
manager resumes the worker at the current service frontier (one past
the newest committed version), so its first pulls are ordinary
requests whose staleness is within the bound by construction. The
enforcer never compares a resumed round index against the worker's
pre-crash pull history — it only ever validates the (t, version) pair
it serves.

Server crashes (``server_crash`` faults): a crashed block server's
parked pulls die with its volatile state (:meth:`drop_server`, counted
as dropped pulls); the workers' retransmission timers re-request after
WAL recovery and the fresh request is validated like any other — the
bounded-staleness contract survives recovery because the rebuilt
version history is exactly the committed one.

Unreliable transport: a pull whose response keeps getting lost degrades
gracefully — after the retransmission budget the worker proceeds on its
cached z (:meth:`fallback`), which the enforcer validates against the
SAME tau <= T bound and accounts as ``timeout_fallbacks`` (extra
staleness steps, not violations). A cache too stale to satisfy the
bound is not a legal fallback; the worker keeps retransmitting.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple


class StalenessEnforcer:
    """Gate pulls on the Assumption-3 bound; account stalls."""

    def __init__(self, bound: int):
        if bound < 0:
            raise ValueError(f"staleness bound must be >= 0; got {bound}")
        self.bound = int(bound)
        self.pulls_served = 0
        self.max_served_tau = 0
        self.stall_count = 0
        self.stall_time = 0.0
        self.dropped_pulls = 0
        self.version_resets = 0
        self.timeout_fallbacks = 0
        self.stall_time_by_worker: Dict[int, float] = defaultdict(float)
        self.stall_count_by_worker: Dict[int, int] = defaultdict(int)
        # server sid -> FIFO [(worker id, round t, issue time, resolve)]
        self._waiting: Dict[int, List[Tuple[int, int, float, Callable]]] = {}
        # telemetry (repro_torch.obs.Telemetry) — None keeps every
        # instrumentation site inert; set by PSRuntime.run
        self.obs = None

    def request(self, server, t: int, now: float,
                resolve: Callable[[int], None], *, worker: int = -1) -> bool:
        """Worker round-t pull against ``server``. Resolves immediately
        (returning True) with version ``min(newest, t)`` when that
        read's staleness is within the bound; otherwise parks the pull
        until the server catches up to version ``t - bound``."""
        if server.version >= t - self.bound:
            self._serve(t, min(server.version, t), resolve)
            return True
        self.stall_count += 1
        self.stall_count_by_worker[worker] += 1
        self._waiting.setdefault(server.sid, []).append(
            (worker, t, now, resolve))
        return False

    def notify(self, server, now: float) -> None:
        """``server`` committed a new version — flush satisfiable
        waiters in FIFO order (within the commit event, so resolution
        order is deterministic)."""
        waiters = self._waiting.get(server.sid)
        if not waiters:
            return
        keep = []
        spans = self.obs.spans if self.obs is not None else None
        for (worker, t, issued, resolve) in waiters:
            if server.version >= t - self.bound:
                self.stall_time += now - issued
                self.stall_time_by_worker[worker] += now - issued
                if spans is not None:
                    # the stall window is only known at resolution —
                    # emit the complete span on the worker's track
                    spans.complete(self.obs.worker_track(worker), "stall",
                                   issued, now, round=t, server=server.sid)
                self._serve(t, min(server.version, t), resolve)
            else:
                keep.append((worker, t, issued, resolve))
        if keep:
            self._waiting[server.sid] = keep
        else:
            del self._waiting[server.sid]

    def drop_worker(self, worker: int) -> None:
        """A worker crashed: discard its parked pulls (the resolutions
        would land on a dead incarnation). The stall that ends in a
        crash is counted in ``dropped_pulls``, not ``stall_time``."""
        for sid in list(self._waiting):
            keep = [e for e in self._waiting[sid] if e[0] != worker]
            self.dropped_pulls += len(self._waiting[sid]) - len(keep)
            if keep:
                self._waiting[sid] = keep
            else:
                del self._waiting[sid]

    def drop_server(self, sid: int) -> None:
        """Block server ``sid`` crashed: the pulls parked on it died
        with its volatile state (the server-side dedup entries that
        would route the resolutions are gone). Counted as
        ``dropped_pulls``; the workers' transport retransmission timers
        re-request after WAL recovery, and the fresh request parks or
        serves against the rebuilt state."""
        waiters = self._waiting.pop(sid, None)
        if waiters:
            self.dropped_pulls += len(waiters)

    def fallback(self, t: int, version: int, *, worker: int = -1) -> None:
        """A worker's round-t pull timed out through every retry on an
        unreliable transport, and it is proceeding on its CACHED version
        instead of deadlocking (graceful degradation). The read must
        still satisfy Assumption 3 — the extra staleness steps count
        against the same tau <= T bound every served pull is held to
        (validated here; the caller checks eligibility before falling
        back) — so the recorded trace stays within its declared bound
        and replays unchanged."""
        tau = t - version
        if not 0 <= tau <= self.bound:
            raise AssertionError(
                f"timeout fallback for worker {worker} would read "
                f"tau={tau} outside [0, {self.bound}] — the worker must "
                f"keep retransmitting instead")
        self.timeout_fallbacks += 1
        self.max_served_tau = max(self.max_served_tau, tau)

    def note_rejoin(self) -> None:
        """Membership resumed a worker at the service frontier — count
        the version reset (tau accounting restarts from the resumed
        round; no violation is recorded)."""
        self.version_resets += 1

    def _serve(self, t: int, version: int, resolve) -> None:
        tau = t - version
        if not 0 <= tau <= self.bound:
            raise AssertionError(
                f"staleness enforcer served tau={tau} outside [0, "
                f"{self.bound}] — runtime invariant broken")
        self.pulls_served += 1
        self.max_served_tau = max(self.max_served_tau, tau)
        resolve(version)

    @property
    def idle(self) -> bool:
        return not self._waiting

    def stats(self) -> Dict[str, float]:
        return {"bound": self.bound,
                "pulls_served": self.pulls_served,
                "max_served_tau": self.max_served_tau,
                "stall_count": self.stall_count,
                "stall_time": self.stall_time,
                "dropped_pulls": self.dropped_pulls,
                "version_resets": self.version_resets,
                "timeout_fallbacks": self.timeout_fallbacks}

    def register_metrics(self, reg) -> None:
        """Register the enforcer's instruments (same keys/order as
        :meth:`stats` — the head of ``PSRunResult.metrics``)."""
        reg.gauge("bound", lambda: self.bound)
        reg.counter("pulls_served", lambda: self.pulls_served)
        reg.gauge("max_served_tau", lambda: self.max_served_tau)
        reg.counter("stall_count", lambda: self.stall_count)
        reg.counter("stall_time", lambda: self.stall_time)
        reg.counter("dropped_pulls", lambda: self.dropped_pulls)
        reg.counter("version_resets", lambda: self.version_resets)
        reg.counter("timeout_fallbacks", lambda: self.timeout_fallbacks)
