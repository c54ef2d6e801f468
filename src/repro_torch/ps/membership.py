"""Elastic membership for the PS runtime — who participates in which round.

A parameter-server *service* does not run against a fixed fleet:
workers crash and restart, new workers join mid-run, old ones leave for
good. Algorithm 1 tolerates all of it — the partial-participation
analysis of Chang et al. (arXiv:1509.02597) only needs every round's
commit to fold the updates of the workers that actually pushed, with
everyone else's server-side w~ cache left stale — but the *runtime*
must keep three books straight:

* **gates** — a lock domain's round-v commit waits on declarations from
  the workers ACTIVE for round v, not the static edge neighborhood
  (otherwise one crash deadlocks every server);
* **participation** — every (round, worker) pair is either participated
  (declared) or absent; the matrix goes into the
  :class:`~repro_torch.ps.trace.DelayTrace` so replay masks the absent pairs
  out of the epoch's block selection;
* **resumption** — a rejoining worker cannot re-enter at its crashed
  round: domains may have committed past it (their gates stopped
  waiting on it), so it resumes one past the current *service frontier*
  (the newest version any of its edge domains has committed or is
  committing — strictly future gates, never racing an in-flight
  commit). It pulls fresh z there, while its w~ rows on the servers —
  and its local y — stay stale until its next declare: the
  **version-reset** semantics the StalenessEnforcer accounts (a reset,
  not a tau violation).

This module is pure round-space bookkeeping (intervals of activity per
worker); the sim-time side — when crashes fire, how factors apply — is
:mod:`repro_torch.ps.chaos`, and the wiring is ``PSRuntime``.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np


class MembershipManager:
    """Per-worker activity intervals over the round horizon.

    Worker i's history is a list of half-open round intervals
    ``[start, end)`` (``end=None`` while active). Warm workers open
    ``[0, ·)`` at construction; cold workers (a ``join`` fault event)
    start with no interval and open their first at activation.
    Deactivation closes the open interval at the worker's current
    (uncompleted) round — rounds it fully declared stay participated.
    """

    def __init__(self, num_workers: int, num_rounds: int,
                 cold: Iterable[int] = ()):
        self.N = int(num_workers)
        self.R = int(num_rounds)
        cold = set(cold)
        bad = [i for i in cold if not 0 <= i < self.N]
        if bad:
            raise ValueError(f"cold (join) worker ids {bad} outside "
                             f"[0, {self.N})")
        self._intervals: List[List[List[Optional[int]]]] = [
            [] if i in cold else [[0, None]] for i in range(self.N)]
        self.crashes = 0
        self.rejoins = 0

    # ---- transitions ------------------------------------------------------
    def is_active(self, i: int) -> bool:
        iv = self._intervals[i]
        return bool(iv) and iv[-1][1] is None

    def deactivate(self, i: int, round_from: int) -> None:
        """Worker i went down while working on ``round_from`` (it never
        declared it): absent from that round until (re)activation."""
        if not self.is_active(i):
            raise RuntimeError(f"worker {i} deactivated while not active")
        iv = self._intervals[i]
        if iv[-1][0] >= round_from:       # interval never covered a round
            iv.pop()
        else:
            iv[-1][1] = round_from
        self.crashes += 1

    def activate(self, i: int, round_from: int) -> None:
        """Worker i resumes participation at ``round_from`` (computed by
        the runtime as one past its edge domains' service frontier)."""
        if self.is_active(i):
            raise RuntimeError(f"worker {i} activated while already active")
        last_end = self._intervals[i][-1][1] if self._intervals[i] else 0
        if round_from < last_end:
            raise RuntimeError(
                f"worker {i} resumed at round {round_from} inside its "
                f"absence window (absent from {last_end}) — resumption "
                f"must be at the service frontier")
        if round_from < self.R:
            self._intervals[i].append([round_from, None])
        self.rejoins += 1

    # ---- durability (runtime snapshots) ----------------------------------
    def state_dict(self) -> dict:
        """JSON-serializable membership state for a runtime snapshot."""
        return {"intervals": [[list(iv) for iv in worker]
                              for worker in self._intervals],
                "crashes": self.crashes, "rejoins": self.rejoins}

    def restore_state(self, state: dict) -> None:
        """Restore from :meth:`state_dict` (JSON round-tripped: open
        intervals' ``None`` ends survive as nulls)."""
        if len(state["intervals"]) != self.N:
            raise ValueError(
                f"membership snapshot covers {len(state['intervals'])} "
                f"workers; this runtime has {self.N}")
        self._intervals = [[list(iv) for iv in worker]
                           for worker in state["intervals"]]
        self.crashes = state["crashes"]
        self.rejoins = state["rejoins"]

    # ---- queries ----------------------------------------------------------
    def required(self, i: int, v: int) -> bool:
        """Does round v's commit gate wait on worker i's declaration?"""
        for (s, e) in self._intervals[i]:
            if s <= v < (self.R if e is None else e):
                return True
        return False

    def participated_rounds(self, i: int) -> int:
        return sum((self.R if e is None else e) - s
                   for (s, e) in self._intervals[i])

    def participation_matrix(self) -> np.ndarray:
        """(rounds, N) bool — True where worker i declared round t."""
        P = np.zeros((self.R, self.N), bool)
        for i in range(self.N):
            for (s, e) in self._intervals[i]:
                P[s:(self.R if e is None else e), i] = True
        return P

    @property
    def elastic(self) -> bool:
        """Whether any worker was ever absent for any round."""
        return any(iv != [[0, None]] for iv in self._intervals)
