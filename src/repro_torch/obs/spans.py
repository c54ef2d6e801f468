"""Span tracer — the PS schedule as a Chrome trace, in virtual time.

Spans live on entity *tracks* ("worker 3", "server 0", "runtime"),
mapped onto Chrome trace-event pid/tid pairs so Perfetto
(https://ui.perfetto.dev) renders each entity as its own swimlane.
All timestamps are the DES's *simulated* seconds scaled to
microseconds (the trace-event unit) — wall-clock never appears, which
is what makes the export deterministic: two runs of the same seed
produce byte-identical span lists.

Recording is append-only list pushes (no rng, no scheduling, no
reading of volatile numeric state) — the determinism contract's
"never perturb the schedule" in practice. Span/instant/counter names
validate against :data:`repro_torch.obs.names.SPAN_NAMES`, so the span
vocabulary cannot drift from the documented schema.

Export: :meth:`to_chrome` returns the ``{"traceEvents": [...]}`` JSON
object (complete "X" spans, instant "i" events, counter "C" samples,
plus thread-name metadata), :meth:`save` writes it. Load it in
Perfetto or ``chrome://tracing`` directly.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List

from .names import SPAN_NAMES, validate_kind

_SCALE = 1e6          # sim seconds -> trace-event microseconds


class SpanTracer:
    """Deterministic virtual-time span recorder for one run."""

    def __init__(self):
        self._events: List[Dict[str, Any]] = []
        self._tids: Dict[str, int] = {}

    # ------------------------------------------------------------------
    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids) + 1
        return tid

    def _check(self, name: str, expected: str) -> None:
        kind = validate_kind(name, frozenset(SPAN_NAMES), "span")
        actual = SPAN_NAMES[name][0]
        if actual != expected:
            raise ValueError(
                f"span name {name!r} is declared as {actual!r} in "
                f"repro_torch.obs.names.SPAN_NAMES but emitted as "
                f"{expected!r}")

    # ------------------------------------------------------------------
    def complete(self, track: str, name: str, start: float, end: float,
                 **args: Any) -> None:
        """A duration span [start, end] (sim seconds) on ``track``."""
        self._check(name, "complete")
        if end < start:
            raise ValueError(f"span {name!r} ends before it starts "
                             f"({end} < {start})")
        self._events.append({
            "name": name, "ph": "X", "pid": 1, "tid": self._tid(track),
            "ts": start * _SCALE, "dur": (end - start) * _SCALE,
            "args": args})

    def instant(self, track: str, name: str, t: float,
                **args: Any) -> None:
        """A point event at sim time ``t`` on ``track``."""
        self._check(name, "instant")
        self._events.append({
            "name": name, "ph": "i", "s": "t", "pid": 1,
            "tid": self._tid(track), "ts": t * _SCALE, "args": args})

    def counter(self, track: str, name: str, t: float,
                **values: float) -> None:
        """A sampled counter value at sim time ``t``."""
        self._check(name, "counter")
        self._events.append({
            "name": name, "ph": "C", "pid": 1,
            "tid": self._tid(track), "ts": t * _SCALE, "args": values})

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    def to_chrome(self, meta: Dict[str, Any] | None = None) -> Dict:
        """The Chrome trace-event JSON object: thread-name metadata
        (one per track, in first-use order) + recorded events."""
        header = [{
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": track}}
            for track, tid in self._tids.items()]
        out = {"traceEvents": header + self._events,
               "displayTimeUnit": "ms"}
        if meta:
            out["otherData"] = dict(meta)
        return out

    def save(self, path: str, meta: Dict[str, Any] | None = None) -> str:
        """Write the Perfetto-loadable trace JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(meta), f)
        return path
