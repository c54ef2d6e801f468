"""Per-round record sinks — watch a consensus run while it executes.

The PS runtime emits one record each time a round *completes* (every
lock domain has published the round's version), at the configured
``metrics_every`` cadence. A record is a plain JSON-able dict:

  {"round": r, "version": r+1, "sim_time": ..., "loss": ...,
   "stationarity": {"P": ..., "primal_residual": ...,
                    "prox_residual": ..., "grad_norm": ...,
                    "per_block": {"primal": [...], "prox": [...],
                                  "grad": [...], "P": [...]}} | null,
   "queue_depth": [...per domain...], "commits": ..., "pushes": ...,
   "stall_count": ..., "stall_time": ...,
   "transport": {...} | null}

``stationarity`` is null when the runtime cannot compute it without
perturbing the run (timing-only mode, ``track_x=False`` sessions,
streamed ``batches=`` data, or a block server currently down);
``transport`` is null on reliable runs. Records are computed from
committed state and monotone counters only — no rng, no scheduled
events — so streaming on/off cannot change the run (the determinism
contract of ``repro_torch.obs``).

Sinks are pluggable: :class:`JsonlSink` (one JSON object per line),
:class:`StdoutSink` (live mode for a terminal), :class:`CallbackSink`
(in-process consumer via ``run_ps(telemetry=callable)``).
:func:`make_sink` coerces what users pass; :func:`validate_record`
pins the schema (CI validates every streamed line against it).
"""
from __future__ import annotations

import json
import sys
from typing import Any, Callable, Dict, IO, Optional


class Sink:
    """A per-round record consumer. ``emit`` must not raise on
    well-formed records; ``close`` flushes/releases resources."""

    def emit(self, record: Dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError

    def close(self) -> None:
        pass


class JsonlSink(Sink):
    """Append records to ``path``, one JSON object per line."""

    def __init__(self, path: str):
        self.path = str(path)
        self._f: Optional[IO[str]] = open(self.path, "w")

    def emit(self, record: Dict[str, Any]) -> None:
        assert self._f is not None, "sink already closed"
        self._f.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class StdoutSink(Sink):
    """Live mode: one JSON line per record to a stream (stdout)."""

    def __init__(self, stream: Optional[IO[str]] = None):
        self._stream = stream

    def emit(self, record: Dict[str, Any]) -> None:
        stream = self._stream or sys.stdout
        stream.write(json.dumps(record) + "\n")
        stream.flush()


class CallbackSink(Sink):
    """Hand each record to an in-process callable."""

    def __init__(self, fn: Callable[[Dict[str, Any]], None]):
        self._fn = fn

    def emit(self, record: Dict[str, Any]) -> None:
        self._fn(record)


def make_sink(spec: Any) -> Optional[Sink]:
    """Coerce a user-facing sink spec: None -> None, a Sink ->
    itself, a callable -> CallbackSink, "stdout"/"-" -> StdoutSink,
    any other string/path -> JsonlSink."""
    if spec is None:
        return None
    if isinstance(spec, Sink):
        return spec
    if callable(spec):
        return CallbackSink(spec)
    if isinstance(spec, (str, bytes)) or hasattr(spec, "__fspath__"):
        path = str(spec)
        if path in ("stdout", "-"):
            return StdoutSink()
        return JsonlSink(path)
    raise TypeError(
        f"cannot make a telemetry sink from {type(spec).__name__}: pass "
        f"None, a repro_torch.obs.Sink, a callable, 'stdout', or a file path")


# ---------------------------------------------------------------------------
# record schema (CI validates the emitted JSONL against this)
# ---------------------------------------------------------------------------

#: required top-level keys -> allowed types (None encodes "nullable").
ROUND_RECORD_SCHEMA: Dict[str, tuple] = {
    "round":        (int,),
    "version":      (int,),
    "sim_time":     (float, int),
    "loss":         (float, int, type(None)),
    "stationarity": (dict, type(None)),
    "queue_depth":  (list,),
    "commits":      (int,),
    "pushes":       (int,),
    "stall_count":  (int,),
    "stall_time":   (float, int),
    "transport":    (dict, type(None)),
}

_STATIONARITY_KEYS = ("P", "primal_residual", "prox_residual",
                      "grad_norm", "per_block")
_PER_BLOCK_KEYS = ("primal", "prox", "grad", "P")


def validate_record(record: Dict[str, Any]) -> Dict[str, Any]:
    """Check one streamed record against the schema; raises
    ``ValueError`` naming the offending key. Returns the record."""
    for key, types in ROUND_RECORD_SCHEMA.items():
        if key not in record:
            raise ValueError(f"round record missing key {key!r}; "
                             f"got keys {sorted(record)}")
        if not isinstance(record[key], types):
            raise ValueError(
                f"round record key {key!r} has type "
                f"{type(record[key]).__name__}, expected one of "
                f"{[t.__name__ for t in types]}")
    st = record["stationarity"]
    if st is not None:
        missing = [k for k in _STATIONARITY_KEYS if k not in st]
        if missing:
            raise ValueError(f"stationarity block missing {missing}")
        pb = st["per_block"]
        bad = [k for k in _PER_BLOCK_KEYS
               if not isinstance(pb.get(k), list)]
        if bad:
            raise ValueError(f"stationarity per_block keys {bad} must "
                             f"be lists of per-block floats")
    return record
