"""The observability name registries — one place, no silent drift.

Every name the telemetry subsystem emits is declared here:

* ``TRACE_EVENT_KINDS`` — the chaos-timeline kinds a
  :class:`~repro_torch.ps.trace.DelayTrace` may carry (``add_event``
  validates against this set, so a new fault type cannot invent a
  trace-event spelling the telemetry layer does not know);
* ``TRANSPORT_EVENT_KINDS`` — the per-link delivery-decision kinds
  (``add_transport`` validates the same way);
* ``SPAN_NAMES`` — the span/instant vocabulary of the Chrome-trace
  export (``obs/spans.py`` refuses unknown names);
* ``STEP_SPANS`` — the wall-clock ranges of the port's step
  (``obs/step.py``'s ``step_span`` refuses unknown names), recorded
  into ``torch.profiler``'s own trace;
* ``METRICS`` — the stable metric names of the registry
  (``obs/metrics.py`` refuses unregistered spellings), with units and
  one-line descriptions. These names ARE the public contract
  (API.md's metric table is generated from this dict's entries), so a
  rename is an API change, not a refactor.

Keeping the registries next to each other is the point: the PS
runtime's trace events, the span tracer's tracks and the metrics
registry all describe the same underlying schedule, and the names
must agree for a Perfetto trace, a JSONL stream and a saved
``DelayTrace`` to be cross-referenced.
"""
from __future__ import annotations

from typing import Mapping

# ---------------------------------------------------------------------------
# DelayTrace event kinds (ps/trace.py validates against these)
# ---------------------------------------------------------------------------

#: Chaos-timeline kinds recorded via ``DelayTrace.add_event`` — the
#: fault transitions (ps/runtime.py) plus the queried factor windows
#: the injector logs up front (ps/chaos.py).
TRACE_EVENT_KINDS = frozenset({
    "crash",           # worker lost mid-cycle (transient)
    "leave",           # worker left permanently
    "join",            # cold worker joined mid-run
    "rejoin",          # crashed worker resumed
    "slowdown",        # transient worker compute multiplier window
    "server_spike",    # transient server commit-latency window
    "link_loss",       # burst packet-loss window on matching links
    "server_crash",    # block server lost its volatile state
    "server_recover",  # block server rebuilt from its WAL
})

#: Per-link delivery decisions recorded via ``DelayTrace.add_transport``
#: (ps/transport.py's ``LinkChannel`` is the only writer).
TRANSPORT_EVENT_KINDS = frozenset({
    "drop",            # message lost on the link
    "dup",             # message delivered twice
    "reorder",         # delivery held back past later traffic
    "retransmit",      # sender's timeout fired, message resent
    "pull_timeout",    # pull degraded to the cached version
})


def validate_kind(kind: str, registry: frozenset, what: str) -> str:
    """Raise an actionable ``ValueError`` when ``kind`` is not a
    registered ``what`` name; returns ``kind`` unchanged otherwise."""
    if kind not in registry:
        raise ValueError(
            f"unknown {what} kind {kind!r}; registered kinds: "
            f"{sorted(registry)}. Register new kinds in "
            f"repro_torch.obs.names so telemetry spans, trace events and "
            f"the metrics registry cannot silently diverge.")
    return kind


# ---------------------------------------------------------------------------
# span vocabulary (obs/spans.py validates against these)
# ---------------------------------------------------------------------------

#: name -> (event type, description). ``complete`` spans have duration
#: (Chrome "X"); ``instant`` marks a point (Chrome "i"); ``counter`` is
#: a sampled value track (Chrome "C"). Times are virtual sim-seconds.
SPAN_NAMES: Mapping[str, tuple] = {
    # worker tracks
    "pull":          ("complete", "pull issue -> version resolved (RTT "
                                  "incl. stall/retransmission)"),
    "stall":         ("complete", "bounded-staleness stall: pull parked "
                                  "-> commit that satisfied it"),
    "compute":       ("complete", "worker service time for one round"),
    "down":          ("complete", "entity dead: crash/leave -> "
                                  "rejoin/recovery (or run end)"),
    # server tracks
    "queue_wait":    ("complete", "time an item sat behind earlier work "
                                  "in the lock domain's serial queue"),
    "push_service":  ("complete", "push processing occupancy (+ eager "
                                  "commit draw under per_push)"),
    "commit_service": ("complete", "round-boundary commit occupancy"),
    "commit":        ("instant",  "version published (args: version, "
                                  "folds)"),
    "wal_replay":    ("instant",  "WAL replay rebuilt the domain (args: "
                                  "replayed versions)"),
    "snapshot":      ("complete", "quiescent barrier: first worker "
                                  "parked -> snapshot written"),
    # chaos / transport instants (same spellings as the trace logs)
    "crash":         ("instant",  "worker crash"),
    "leave":         ("instant",  "worker permanent leave"),
    "join":          ("instant",  "cold worker joined"),
    "rejoin":        ("instant",  "worker resumed"),
    "server_crash":  ("instant",  "block server lost volatile state"),
    "server_recover": ("instant", "block server recovered"),
    "drop":          ("instant",  "link dropped a message"),
    "dup":           ("instant",  "link duplicated a message"),
    "reorder":       ("instant",  "link held a message back"),
    "retransmit":    ("instant",  "sender retransmitted"),
    "pull_timeout":  ("instant",  "pull fell back to the cached z"),
    # counter tracks
    "queue_depth":   ("counter",  "unprocessed pushes per lock domain"),
    "events":        ("counter",  "scheduler events processed"),
}


# ---------------------------------------------------------------------------
# step spans (obs/step.py validates against these)
# ---------------------------------------------------------------------------

#: name -> (parent, description). Wall-clock ranges at the boundaries
#: of the port's step, recorded as ``RecordFunction`` ranges while a
#: ``torch.profiler`` session records (and never otherwise), so they
#: share the profiler's clock with the kernels and runtime calls they
#: launch.
#: ``parent`` is the span each nests in when one encloses it: a flat
#: ``ConsensusSession.step`` opens ``asybadmm.epoch`` outermost, and the
#: PS runtime's worker computes record the three ``worker_grads`` spans
#: alone.
STEP_SPANS: Mapping[str, tuple] = {
    "admm.train_step": (None, "ADMMTrainer.train_step / "
                              "train_step_block: the state packed, the "
                              "epoch or block round, the state unpacked"),
    "asybadmm.epoch":  ("admm.train_step", "one epoch of Algorithm 1 "
                        "(asybadmm_epoch, the SPMD epoch, the block "
                        "round); B1, rho_sum and B2 are its own time"),
    "asybadmm.gather": ("asybadmm.epoch", "the delay draw and the "
                        "gather of z~ from the ring"),
    "asybadmm.unpack": ("asybadmm.epoch", "z~ from the block table to "
                        "the loss's representation (FlatBlocks / "
                        "BlockLayout)"),
    "asybadmm.loss":   ("asybadmm.epoch", "vmap(grad_and_value(loss)): "
                        "the loss's forward and backward"),
    "asybadmm.pack":   ("asybadmm.epoch", "the gradient back onto the "
                        "block table"),
    "asybadmm.select": ("asybadmm.epoch", "the block selector, the "
                        "participation mask and the info means"),
    "asybadmm.push":   ("asybadmm.epoch", "the new z into the ring"),
}


# ---------------------------------------------------------------------------
# stable metric names (obs/metrics.py validates against these)
# ---------------------------------------------------------------------------

#: name -> (kind, unit, description). ``kind`` is the instrument type
#: the registry will accept for the name. The spellings match
#: ``PSRunResult.metrics`` keys exactly — the registry IS how
#: ``ps/runtime.py`` assembles that dict, so this table is the
#: authoritative metric contract (mirrored in API.md).
METRICS: Mapping[str, tuple] = {
    # staleness enforcement (ps/staleness.py)
    "bound":                  ("gauge",   "versions", "Assumption-3 T"),
    "pulls_served":           ("counter", "pulls",    "pulls served"),
    "max_served_tau":         ("gauge",   "versions", "max staleness served"),
    "stall_count":            ("counter", "stalls",   "pulls that parked"),
    "stall_time":             ("counter", "sim_s",    "total stall time"),
    "dropped_pulls":          ("counter", "pulls",    "parked pulls dropped "
                                                      "by crashes"),
    "version_resets":         ("counter", "events",   "rejoin version resets"),
    "timeout_fallbacks":      ("counter", "pulls",    "cached-z fallbacks"),
    # scheduler / servers (ps/events.py, ps/server.py)
    "makespan":               ("gauge",   "sim_s",    "final simulated time"),
    "events":                 ("counter", "events",   "scheduler events "
                                                      "processed"),
    "commits":                ("counter", "commits",  "versions published"),
    "pushes":                 ("counter", "pushes",   "w pushes received"),
    "server_busy_time":       ("gauge",   "sim_s",    "per-domain occupancy"),
    "server_busy_frac":       ("gauge",   "fraction", "per-domain occupancy "
                                                      "/ makespan"),
    "server_wait_time":       ("gauge",   "sim_s",    "per-domain queueing "
                                                      "delay"),
    # workers / membership (ps/worker.py, ps/membership.py)
    "stall_time_per_worker":  ("gauge",   "sim_s",    "per-worker stall time"),
    "stall_count_per_worker": ("gauge",   "stalls",   "per-worker stalls"),
    "participated_rounds":    ("gauge",   "rounds",   "per-worker rounds "
                                                      "participated"),
    "worker_iterations":      ("counter", "rounds",   "total worker-rounds"),
    "crashes":                ("counter", "events",   "worker crashes"),
    "rejoins":                ("counter", "events",   "worker rejoins/joins"),
    "histograms":             ("histogram", "mixed",  "worker_stall_time + "
                                                      "server_occupancy"),
    # durability (ps/recovery.py) — present only when armed
    "server_recoveries":      ("counter", "events",   "WAL-replay rebuilds"),
    "wal":                    ("gauge",   "records",  "WAL record totals"),
    "snapshots":              ("gauge",   "paths",    "snapshot prefixes "
                                                      "written"),
    # transport (ps/transport.py) — present only on lossy runs
    "transport":              ("gauge",   "messages", "fleet-wide delivery "
                                                      "totals"),
}
