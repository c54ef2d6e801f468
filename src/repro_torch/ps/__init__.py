"""Event-driven Parameter Server runtime for AsyBADMM (port of
``repro/ps``).

The subsystem that turns the paper's systems claims — lock-free block
servers, bounded delay (Assumption 3), near-linear speedup (Table 1) —
into executable, measurable, replayable scenarios:

* :class:`EventScheduler` — deterministic discrete-event clock;
* :class:`BlockServerProc` + ``DISCIPLINES`` — per-block ``lockfree``
  servers vs the ``locked`` full-vector baseline (paper §1), plus the
  eager ``per_push`` commit discipline;
* :class:`WorkerProc` — workers running the REAL variable-space hot
  path (on the card: the B1 worker-update kernel per compute, the B2
  server kernel per block commit);
* :class:`StalenessEnforcer` — stalls pulls that would violate
  ``tau <= T`` instead of silently clipping;
* :class:`FaultPlan` / :class:`FaultInjector` +
  :class:`MembershipManager` — deterministic chaos (crash / rejoin /
  join / leave / slowdown / server spikes / link loss) over an elastic
  fleet;
* :class:`Transport` + :class:`TransportFabric` — unreliable
  worker<->server links (drop / duplicate / reorder, seeded per link)
  with ack/retry/backoff reliability, exactly-once commit folds, and
  graceful pull-timeout degradation within Assumption 3's bound;
* :class:`DomainWAL` + :class:`SnapshotCoordinator`
  (``ps/recovery.py``) — durability: per-domain write-ahead commit
  logs that rebuild a crashed block server exactly (``server_crash``
  faults, zero committed folds lost; on the card one B2 launch per
  replayed block version), and crash-consistent runtime snapshots with
  deterministic mid-run resume (``run_ps(checkpoint_every=,
  resume_from=)``), in the reference's snapshot format;
* :class:`DelayTrace` — records what happened (staleness + partial
  participation + chaos events + transport delivery log); replays
  through ``asybadmm_epoch`` via ``core.space.TraceDelay`` exactly, in
  the reference's file format;
* :class:`PSRuntime` / :class:`PSRunResult` — the front door, also
  reachable as ``ConsensusSession.run_ps(...)``.
"""
from .chaos import FaultEvent, FaultInjector, FaultPlan
from .engine import SpaceEngine
from .events import EventScheduler
from .membership import MembershipManager
from .recovery import (DomainWAL, SnapshotCoordinator, latest_snapshot,
                       list_snapshots, load_snapshot)
from .runtime import PSRunResult, PSRuntime
from .server import (BlockServerProc, Discipline, DISCIPLINES,
                     register_discipline, resolve_discipline)
from .staleness import StalenessEnforcer
from .timing import (SERVICE_MODELS, ConstantService, CostProfile,
                     LognormalService, NetworkModel, ParetoService,
                     ServiceModel, Transport, as_network, as_service,
                     measure_costs)
from .trace import DelayTrace
from .transport import LinkChannel, TransportFabric
from .worker import WorkerProc

__all__ = [
    "SpaceEngine", "EventScheduler", "PSRunResult", "PSRuntime",
    "BlockServerProc", "Discipline", "DISCIPLINES", "register_discipline",
    "resolve_discipline", "StalenessEnforcer", "SERVICE_MODELS",
    "ConstantService", "CostProfile", "LognormalService", "NetworkModel",
    "ParetoService", "ServiceModel", "Transport", "as_network",
    "as_service", "measure_costs", "DelayTrace", "LinkChannel",
    "TransportFabric", "WorkerProc",
    "FaultEvent", "FaultInjector", "FaultPlan", "MembershipManager",
    "DomainWAL", "SnapshotCoordinator", "latest_snapshot",
    "list_snapshots", "load_snapshot",
]
