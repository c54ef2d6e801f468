"""DelayTrace — what the PS runtime actually observed, replayable.

Every pull the runtime serves is a (round t, worker i, block j) read of
some committed version u <= t; the trace records the full staleness
matrix ``delays[t, i, j] = t - u``. Because the runtime realizes
Algorithm 1's logical dataflow exactly (round-r pushes commit block
version r+1), replaying a recorded trace through the fast vectorized
``asybadmm_epoch`` via :class:`repro_torch.core.space.TraceDelay` reproduces
the runtime's z trajectory — structurally exact, bitwise on the cuda
backend (pinned by ``chip_smoke.py`` on the card), within fp32
rounding on the plain torch backend (pinned by
tests/test_torch_ps_runtime.py) — the bridge that lets every
scheduling/straggler scenario discovered under the event-driven
runtime re-run at epoch speed. The file format is the reference
package's, so a trace recorded by either package replays in the
other.

Elastic runs add **partial participation**: ``participation[t, i]`` is
False for rounds worker i missed (crashed, left, or not yet joined) —
its delay row stays -1 (nothing was pulled) and replay contributes no
edge updates for that (round, worker), via the selection mask in
:class:`~repro_torch.core.space.TraceDelay`. Chaos timeline entries
(``events``: crash / rejoin / join / leave / slowdown / server_spike /
server_crash / server_recover dicts) ride along for analysis and are
round-trip persisted. Server recovery gaps need no special replay
handling: WAL replay rebuilds exactly the committed versions, so the
staleness matrix the workers observed is already the effective
schedule (the gap shows up as stalls/retransmits in sim time, not as
extra staleness beyond the recorded taus).

File format (``.npz``): ``delays`` (rounds, N, M) int32, ``bound`` (the
Assumption-3 T the enforcer guaranteed), ``discipline``, a JSON
``meta`` blob (timing config, seeds, makespan), and — only when the run
was elastic — ``participation`` (rounds, N) bool and a JSON ``events``
list, and — only when the run went over an unreliable transport — a
JSON ``transport`` delivery log. Older files simply lack the newer
keys; ``load`` defaults them (full participation, no events, no
transport log), so old traces keep loading. ``load`` validates the archive eagerly and
raises an actionable ``ValueError`` (file, offending key, shape) on
truncated/corrupt files.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class DelayTrace:
    delays: np.ndarray                 # (rounds, N, M) int32; -1 = unrecorded
    bound: int                         # Assumption 3's T enforced at record time
    discipline: str = "lockfree"
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # (rounds, N) bool; None = full participation (pre-chaos traces)
    participation: Optional[np.ndarray] = None
    # chaos timeline: [{"kind": "crash"|"rejoin"|"join"|"leave"|
    #                   "slowdown"|"server_spike"|"link_loss"|
    #                   "server_crash"|"server_recover", ...}]
    events: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # unreliable-transport delivery log: every drop / dup / reorder /
    # retransmit / pull-timeout decision, in decision order. Debugging
    # detail only — the staleness matrix + participation mask (the
    # EFFECTIVE committed schedule) are what replay consumes, so lossy
    # traces replay through ``asybadmm_epoch`` exactly like reliable
    # ones. Empty (and unsaved) on reliable runs.
    transport: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    @classmethod
    def empty(cls, num_rounds: int, n_workers: int, n_blocks: int,
              bound: int, discipline: str = "lockfree") -> "DelayTrace":
        return cls(delays=np.full((num_rounds, n_workers, n_blocks), -1,
                                  np.int32),
                   bound=int(bound), discipline=discipline)

    # ---- recording -------------------------------------------------------
    def record(self, t: int, i: int, row) -> None:
        """Record worker i's round-t staleness row (M,)."""
        self.delays[t, i, :] = np.asarray(row, np.int32)

    def set_participation(self, part) -> None:
        """Install the (rounds, N) participation matrix from an elastic
        run and erase any partially-recorded rows of absent (t, i)
        pairs (a worker that crashed mid-compute recorded its staleness
        row but never declared — the round did not happen for it)."""
        p = np.asarray(part, bool)
        if p.shape != self.delays.shape[:2]:
            raise ValueError(
                f"participation must be (rounds, N) = "
                f"{self.delays.shape[:2]}; got shape {p.shape}")
        self.delays[~p] = -1
        self.participation = None if p.all() else p

    def add_event(self, kind: str, **fields) -> None:
        """Append one chaos-timeline entry. ``kind`` must be declared
        in :data:`repro_torch.obs.names.TRACE_EVENT_KINDS` — the shared
        registry that keeps trace spellings and telemetry span names
        from silently diverging."""
        from ..obs.names import TRACE_EVENT_KINDS, validate_kind
        validate_kind(kind, TRACE_EVENT_KINDS, "trace event")
        self.events.append({"kind": kind, **fields})

    def add_transport(self, kind: str, **fields) -> None:
        """Log one delivery decision (drop/dup/reorder/retransmit/
        pull_timeout) from a lossy link — the TransportFabric's
        recorder hook. ``kind`` validates against
        :data:`repro_torch.obs.names.TRANSPORT_EVENT_KINDS`."""
        from ..obs.names import TRANSPORT_EVENT_KINDS, validate_kind
        validate_kind(kind, TRANSPORT_EVENT_KINDS, "transport event")
        self.transport.append({"kind": kind, **fields})

    @property
    def num_rounds(self) -> int:
        return self.delays.shape[0]

    def _participation_full(self) -> np.ndarray:
        if self.participation is None:
            return np.ones(self.delays.shape[:2], bool)
        return self.participation

    @property
    def complete(self) -> bool:
        """All participating (round, worker) pulls recorded — and no
        phantom rows recorded for absent pairs."""
        p = self._participation_full()[:, :, None]
        return bool(((self.delays >= 0) == p).all())

    def validate(self) -> "DelayTrace":
        if not self.complete:
            raise ValueError("trace has unrecorded (round, worker) pulls "
                             "(or recorded rows for absent workers)")
        mx = int(self.delays.max())
        if mx > self.bound:
            raise ValueError(f"trace violates its own staleness bound: "
                             f"max tau {mx} > T={self.bound}")
        return self

    # ---- replay ----------------------------------------------------------
    def to_delay_model(self):
        """The :class:`~repro_torch.core.space.TraceDelay` that replays this
        trace through ``asybadmm_epoch`` (any space/backend/mesh) —
        carrying the partial-participation mask when the run was
        elastic."""
        from ..core.space import TraceDelay
        self.validate()
        return TraceDelay(self.delays, participation=self.participation)

    # ---- persistence -----------------------------------------------------
    def save(self, path: str) -> str:
        if not str(path).endswith(".npz"):
            path = f"{path}.npz"
        extra = {}
        if self.participation is not None:
            extra["participation"] = self.participation
        if self.events:
            extra["events"] = np.str_(json.dumps(self.events))
        if self.transport:
            extra["transport"] = np.str_(json.dumps(self.transport))
        np.savez(path, delays=self.delays, bound=np.int32(self.bound),
                 discipline=np.str_(self.discipline),
                 meta=np.str_(json.dumps(self.meta)), **extra)
        return path

    # keys every trace file must carry / may carry (optional ones are
    # absent on pre-chaos / reliable-transport files — load defaults
    # them, so old traces keep loading)
    _REQUIRED_KEYS = ("delays", "bound", "discipline")
    _OPTIONAL_KEYS = ("meta", "participation", "events", "transport")

    @staticmethod
    def load(path: str) -> "DelayTrace":
        """Load a saved trace, failing with an ACTIONABLE error — the
        file, the missing/extra key, or the shape that is wrong — on a
        truncated or corrupt npz instead of leaking a raw numpy
        exception from deep inside the zip reader."""
        def bad(problem: str) -> ValueError:
            return ValueError(
                f"DelayTrace.load: {path!r} is not a valid trace file — "
                f"{problem}. Expected an .npz written by DelayTrace.save "
                f"with keys {list(DelayTrace._REQUIRED_KEYS)} (+ optional "
                f"{list(DelayTrace._OPTIONAL_KEYS)}); re-record the trace "
                f"or check the file was fully written.")
        try:
            f = np.load(path, allow_pickle=False)
        except FileNotFoundError:
            raise
        except Exception as e:
            raise bad(f"unreadable as npz ({type(e).__name__}: {e}); the "
                      f"file is likely truncated or not an npz archive") \
                from e
        with f:
            keys = set(f.files)
            missing = [k for k in DelayTrace._REQUIRED_KEYS
                       if k not in keys]
            if missing:
                raise bad(f"missing required key(s) {missing}; "
                          f"found {sorted(keys)}")
            extra = sorted(keys - set(DelayTrace._REQUIRED_KEYS)
                           - set(DelayTrace._OPTIONAL_KEYS))
            if extra:
                raise bad(f"unrecognized key(s) {extra}; this file was "
                          f"not written by DelayTrace.save (or by a "
                          f"newer incompatible version)")
            try:
                delays = np.asarray(f["delays"], np.int32)
                bound = int(f["bound"])
                discipline = str(f["discipline"])
                meta = json.loads(str(f["meta"])) if "meta" in f else {}
                participation = (np.asarray(f["participation"], bool)
                                 if "participation" in f else None)
                events = (json.loads(str(f["events"]))
                          if "events" in f else [])
                transport = (json.loads(str(f["transport"]))
                             if "transport" in f else [])
            except Exception as e:
                raise bad(f"corrupt array/JSON payload "
                          f"({type(e).__name__}: {e})") from e
        if delays.ndim != 3:
            raise bad(f"'delays' must be (rounds, N, M) 3-d; got shape "
                      f"{delays.shape}")
        if participation is not None \
                and participation.shape != delays.shape[:2]:
            raise bad(f"'participation' shape {participation.shape} does "
                      f"not match delays' (rounds, N) = {delays.shape[:2]}")
        return DelayTrace(delays=delays, bound=bound,
                          discipline=discipline, meta=meta,
                          participation=participation, events=events,
                          transport=transport)
