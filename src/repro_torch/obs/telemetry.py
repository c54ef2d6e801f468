"""Telemetry — the one handle the PS runtime threads everywhere.

A :class:`Telemetry` bundles the three observability layers (span
tracer, metrics registry, per-round stream sink) behind a single
object the runtime stores as ``rt.obs``. Every instrumentation site in
``repro_torch.ps`` is guarded by ``rt.obs is not None`` — telemetry off
means *no object*, zero calls, zero state: the telemetry-off run is
the pre-telemetry runtime, byte for byte.

The determinism contract, concretely:

* recording uses **virtual sim-time only** (the DES clock) — no
  wall-clock reads;
* recording **consumes no rng** — every instrumented site records
  values the schedule already produced;
* recording **schedules nothing and reorders nothing** — appends to
  Python lists and dict counters only.

So a telemetry-on run commits the identical z trajectory (bitwise),
fold logs and makespan as the telemetry-off run — pinned by
``tests/test_torch_obs.py``.

Construction: ``Telemetry(...)`` directly for full control, or
:func:`as_telemetry` to coerce what ``run_ps(telemetry=)`` accepts
(True, a path, "stdout", a callable, a Sink, or a Telemetry).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from .spans import SpanTracer
from .stream import Sink, make_sink


class Telemetry:
    """Span tracer + stream sink + round-completion bookkeeping."""

    def __init__(self, *, spans: bool = True, sink: Any = None,
                 metrics_every: int = 1,
                 trace_path: Optional[str] = None):
        if metrics_every < 1:
            raise ValueError(f"metrics_every must be >= 1; "
                             f"got {metrics_every}")
        self.spans: Optional[SpanTracer] = SpanTracer() if spans else None
        self.sink: Optional[Sink] = make_sink(sink)
        self.metrics_every = int(metrics_every)
        self.trace_path = trace_path
        self.records_emitted = 0
        self.events_seen = 0
        self._commit_counts: Dict[int, int] = {}
        # open "down" windows: track name -> sim time the entity died
        # (closed at rejoin/recovery, or at makespan by finalize)
        self._down_since: Dict[str, float] = {}
        self._num_domains = 0
        self._num_rounds = 0
        self._record_fn: Optional[Callable] = None

    # ------------------------------------------------------------------
    # runtime wiring
    # ------------------------------------------------------------------
    def bind(self, *, num_domains: int, num_rounds: int,
             record_fn: Callable[[int, float], Dict[str, Any]]) -> None:
        """Called by ``PSRuntime.run`` before launch: how many lock
        domains make a round complete, and the callback that assembles
        one round record from committed state (read-only)."""
        self._num_domains = int(num_domains)
        self._num_rounds = int(num_rounds)
        self._record_fn = record_fn
        self._commit_counts = {}

    def on_event(self, now: float, tag: Optional[str]) -> None:
        """The scheduler's observer hook (``events.py``): count every
        processed event. Pure accounting — never touches the queue."""
        self.events_seen += 1

    def note_commit(self, sid: int, version: int, now: float) -> None:
        """A lock domain published ``version``. When the last domain
        reaches it, round ``version - 1`` is complete — emit its record
        at the configured cadence. WAL-replay rebuilds do NOT re-enter
        here (those versions were counted at their live commit)."""
        n = self._commit_counts.get(version, 0) + 1
        self._commit_counts[version] = n
        if n != self._num_domains or self.sink is None \
                or self._record_fn is None:
            return
        r = version - 1
        if r % self.metrics_every == 0 or r == self._num_rounds - 1:
            self.sink.emit(self._record_fn(version, now))
            self.records_emitted += 1

    # ------------------------------------------------------------------
    # span conveniences (all no-ops when spans are disabled)
    # ------------------------------------------------------------------
    @staticmethod
    def worker_track(i: int) -> str:
        return f"worker {i}"

    @staticmethod
    def server_track(sid: int) -> str:
        return f"server {sid}"

    RUNTIME_TRACK = "runtime"

    def entity_down(self, track: str, t: float) -> None:
        """Open a "down" window on ``track`` (idempotent while open —
        overlapping fault windows merge, as the runtime's do)."""
        if self.spans is not None:
            self._down_since.setdefault(track, float(t))

    def entity_up(self, track: str, t: float) -> None:
        """Close ``track``'s open "down" window, if any."""
        start = self._down_since.pop(track, None)
        if self.spans is not None and start is not None:
            self.spans.complete(track, "down", start, float(t))

    def transport_recorder(self, inner: Callable) -> Callable:
        """Wrap the DelayTrace transport recorder so every delivery
        decision also lands as an instant on the worker's track."""
        if self.spans is None:
            return inner

        def record(kind: str, **fields: Any) -> None:
            inner(kind, **fields)
            self.spans.instant(
                self.worker_track(fields.get("worker", -1)), kind,
                fields.get("time", 0.0),
                **{k: v for k, v in fields.items()
                   if k not in ("worker", "time")})
        return record

    # ------------------------------------------------------------------
    def finalize(self, meta: Optional[Dict[str, Any]] = None) -> None:
        """End of run: flush/close the sink and save the Chrome trace
        when a ``trace_path`` was configured."""
        if self.sink is not None:
            self.sink.close()
        if self.spans is not None:
            end = (meta or {}).get("makespan")
            if end is not None:
                # entities still dead at the end of the run: close
                # their windows at the makespan (sorted for a stable
                # event order)
                for track in sorted(self._down_since):
                    self.spans.complete(track, "down",
                                        self._down_since[track],
                                        float(end))
                self._down_since.clear()
            if self.trace_path:
                self.spans.save(self.trace_path, meta)


def as_telemetry(spec: Any) -> Optional[Telemetry]:
    """Coerce ``run_ps(telemetry=)``: None/False -> None (inert),
    True -> spans only, a Telemetry -> itself, anything else -> a
    Telemetry streaming to ``make_sink(spec)``."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, Telemetry):
        return spec
    if spec is True:
        return Telemetry(spans=True)
    return Telemetry(spans=True, sink=spec)
