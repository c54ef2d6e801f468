"""repro_torch.obs — deterministic telemetry for the PS runtime.

Three layers, one hard contract:

* :mod:`repro_torch.obs.spans` — a virtual-time span tracer (Chrome
  trace-event JSON, loadable in Perfetto) the runtime hangs pull RTTs,
  stalls, commit queues, retransmit ladders, crash/recovery windows
  and snapshot barriers onto;
* :mod:`repro_torch.obs.metrics` — a registry of lazily-evaluated
  counters/gauges/histograms/series the runtime components register
  instruments into, from which ``PSRunResult.metrics`` is assembled;
* :mod:`repro_torch.obs.stream` — pluggable per-round record sinks (JSONL,
  stdout live mode, in-process callback) carrying loss, per-block
  stationarity/residuals, queue depths, stall and transport totals.

**The contract: telemetry is inert by default and never perturbs the
schedule.** Recording uses the DES's virtual clock only, consumes no
rng, and schedules no events — a telemetry-on run is bitwise
identical (z bitwise, on either backend) to a telemetry-off run, with
equal fold logs and makespan (pinned by ``tests/test_torch_obs.py``).

Metric, span and trace-event names all validate against
:mod:`repro_torch.obs.names` — the single registry that keeps the
vocabularies from drifting apart.
"""
from .metrics import MetricsRegistry, TimeSeries, hist
from .names import (METRICS, SPAN_NAMES, TRACE_EVENT_KINDS,
                    TRANSPORT_EVENT_KINDS, validate_kind)
from .spans import SpanTracer
from .stream import (CallbackSink, JsonlSink, ROUND_RECORD_SCHEMA, Sink,
                     StdoutSink, make_sink, validate_record)
from .telemetry import Telemetry, as_telemetry

__all__ = [
    "MetricsRegistry", "TimeSeries", "hist",
    "METRICS", "SPAN_NAMES", "TRACE_EVENT_KINDS", "TRANSPORT_EVENT_KINDS",
    "validate_kind", "SpanTracer",
    "CallbackSink", "JsonlSink", "ROUND_RECORD_SCHEMA", "Sink",
    "StdoutSink", "make_sink", "validate_record",
    "Telemetry", "as_telemetry",
]
