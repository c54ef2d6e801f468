"""Deterministic discrete-event scheduler — the PS runtime's clock.

A single priority queue of ``(time, seq, callback, tag)`` entries
drives the whole runtime: worker compute completions, push arrivals,
server commits, and stalled-pull resolutions are all events.
Determinism is a hard requirement (traces must replay, CI gates must
not flake), and it comes from two rules:

* ties in ``time`` break by insertion order (``seq`` is a monotonically
  increasing counter), so zero-cost events (e.g. ``t_push == 0``)
  process in the order they were scheduled;
* no entity draws randomness from a shared stream — every worker and
  server owns its own seeded ``numpy`` generator, so service-time draws
  are independent of event interleaving.

Simulated time is unitless; callers decide whether a unit is a second
(measured kernel costs) or an abstract service slot.

Two small extensions exist for the durability layer (not
ported yet: ROADMAP Queue A item 1): events can carry a ``tag`` (the fault injector
tags its chaos timeline "fault", so a checkpoint barrier can tell
pending chaos apart from in-flight work), and an optional
``after_event`` hook runs after every callback (the snapshot
coordinator's quiescence check). ``restore_clock`` fast-forwards the
clock when a run resumes from a snapshot; it refuses to run with
events already queued — restored time must never travel backwards
past scheduled work.

A third hook serves telemetry (``repro_torch.obs``): ``observer``, called as
``observer(now, tag)`` after every callback (and after ``after_event``
— the snapshot barrier's own work is observable too). The observer is
read-only by contract: it must not schedule events, consume rng, or
mutate runtime state — the determinism guarantee that a telemetry-on
run is bitwise identical to a telemetry-off one rests on it.
"""
from __future__ import annotations

import heapq
from typing import Callable, List, Optional, Tuple


class EventScheduler:
    """Run callbacks at simulated times; ``run`` drains the queue."""

    def __init__(self):
        self._q: List[Tuple[float, int, Callable[[], None],
                            Optional[str]]] = []
        self._seq = 0
        self.now = 0.0
        self.events_processed = 0
        self.after_event: Optional[Callable[[], None]] = None
        # telemetry observer: observer(now, tag) after every callback;
        # must never schedule, draw rng, or mutate (see module doc)
        self.observer: Optional[Callable[[float, Optional[str]],
                                         None]] = None

    def at(self, time: float, fn: Callable[[], None],
           tag: Optional[str] = None) -> None:
        """Schedule ``fn`` at absolute simulated ``time``."""
        if time < self.now:
            raise ValueError(f"cannot schedule at {time} < now={self.now}")
        heapq.heappush(self._q, (float(time), self._seq, fn, tag))
        self._seq += 1

    def after(self, delay: float, fn: Callable[[], None],
              tag: Optional[str] = None) -> None:
        """Schedule ``fn`` ``delay`` time units from now."""
        if delay < 0:
            raise ValueError(f"negative delay {delay}")
        self.at(self.now + delay, fn, tag)

    def only_tagged(self, tag: str) -> bool:
        """True when every queued event carries ``tag`` (or the queue
        is empty) — the snapshot coordinator's quiescence test: all
        in-flight work has drained and only future chaos remains."""
        return all(entry[3] == tag for entry in self._q)

    def restore_clock(self, time: float) -> None:
        """Fast-forward the clock to a snapshot's saved time. Only
        legal before anything is queued or processed — resume restores
        the clock first, then re-arms events at/after it."""
        if self._q or self.events_processed:
            raise RuntimeError(
                "restore_clock on a scheduler that already has queued or "
                "processed events — restore before arming anything")
        if time < 0.0:
            raise ValueError(f"cannot restore clock to {time} < 0")
        self.now = float(time)

    def run(self, max_events: int = 10_000_000) -> float:
        """Process events until the queue drains; returns the final
        simulated time (the makespan). ``max_events`` is a runaway
        guard — a healthy run is O(rounds * (workers + servers))."""
        while self._q:
            if self.events_processed >= max_events:
                raise RuntimeError(
                    f"event budget {max_events} exhausted at t={self.now} "
                    f"— likely a runaway commit loop (check num_rounds "
                    f"caps and staleness bounds)")
            time, _, fn, _tag = heapq.heappop(self._q)
            self.now = time
            self.events_processed += 1
            fn()
            if self.after_event is not None:
                self.after_event()
            if self.observer is not None:
                self.observer(self.now, _tag)
        return self.now
