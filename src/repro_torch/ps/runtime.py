"""PSRuntime — wire scheduler + servers + workers + enforcer together.

One call, two products:

* **what happened** — makespan, per-domain queue occupancy, stall
  statistics (the coordination-scalability quantities Table 1
  measures), per-round losses when numerics run;
* **what to replay** — a validated :class:`DelayTrace` whose
  ``TraceDelay`` reproduces the runtime's z trajectory through the
  fast vectorized ``asybadmm_epoch``: structurally exact, bitwise on
  the cuda backend, within fp32 rounding on the plain torch one.

Numerics run through :class:`~repro_torch.ps.engine.SpaceEngine` (the
real ``VariableSpace`` ops: on the card, B1 once per worker compute and
B2 once per block commit); ``compute="timing"`` skips them for pure
coordination studies (``benchmarks/speedup.py``). Every tensor stays on
the spec's device; what reaches the host (selection rows, losses, the
streamed residuals, the watchdog's flag) is copied once per use.

Chaos/elasticity (``faults=``): a :class:`~repro_torch.ps.chaos.FaultPlan`
injects worker crash/restart, permanent leaves, cold joins, transient
compute slowdowns and server commit-latency spikes into the run. The
:class:`~repro_torch.ps.membership.MembershipManager` keeps commit gates and
participation straight (rounds a worker missed contribute no edge
updates), the StalenessEnforcer treats rejoin as a version reset, and
the recorded trace carries the participation matrix + the chaos event
timeline — replay parity holds for chaos runs exactly as for
fault-free ones.

Durability — the reference's ``server_crash`` faults (a block server
rebuilt from its write-ahead commit log) and
``run(checkpoint_every=, checkpoint_dir=, resume_from=)`` snapshots —
is not ported yet: asking for any of it raises ``NotImplementedError``
naming ROADMAP Queue A item 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from ..core.space import ConsensusSpec
from ..obs import MetricsRegistry, as_telemetry, hist
from .chaos import FaultInjector, FaultPlan
from .engine import SpaceEngine
from .events import EventScheduler
from .membership import MembershipManager
from .server import BlockServerProc, resolve_discipline
from .staleness import StalenessEnforcer
from .timing import CostProfile, Transport
from .trace import DelayTrace
from .transport import TransportFabric
from .worker import WorkerProc

DURABILITY_TODO = ("the PS runtime's durability layer (write-ahead commit "
                   "logs, server_crash faults, checkpoint_every / "
                   "checkpoint_dir / resume_from snapshots) is not ported "
                   "yet: ROADMAP Queue A item 1")


@dataclasses.dataclass
class PSRunResult:
    """What a PS-runtime run produced. ``z_final`` / ``z_versions`` are
    in USER representation (flat vectors on the spec's device) like
    every other ``ConsensusSession`` surface; both are None for
    timing-only runs, and ``z_versions`` additionally needs
    ``record_z=True``."""
    makespan: float
    num_rounds: int
    discipline: str
    trace: DelayTrace
    z_final: Optional[Any]               # final consensus value (real mode)
    z_versions: Optional[List[Any]]      # z per version 0..R (record_z)
    losses: Optional[List[float]]        # mean participant loss per round
    metrics: Dict[str, Any]
    # the run's Telemetry (None when telemetry was off): spans carry
    # the Chrome trace (telemetry.spans.save(path)), the sink already
    # received every per-round record
    telemetry: Optional[Any] = None

    def to_delay_model(self):
        return self.trace.to_delay_model()


class PSRuntime:
    """Event-driven Parameter Server over one :class:`ConsensusSpec`."""

    def __init__(self, spec: ConsensusSpec, data=None, batches=None, *,
                 discipline: str = "lockfree",
                 timing: Optional[CostProfile] = None,
                 compute: str = "real",
                 seed: Optional[int] = None,
                 staleness_bound: Optional[int] = None,
                 record_z: bool = True,
                 faults: Optional[FaultPlan] = None,
                 check_finite: bool = False,
                 telemetry: Any = None,
                 metrics_every: Optional[int] = None):
        if compute not in ("real", "timing"):
            raise ValueError(f"compute must be 'real' or 'timing'; "
                             f"got {compute!r}")
        self.spec = spec
        self.engine = SpaceEngine(spec)
        self.discipline = discipline
        disc = resolve_discipline(discipline)
        self.groups = disc.groups(self.engine.M)
        self.per_push = disc.per_push
        covered = sorted(j for g in self.groups for j in g)
        if covered != list(range(self.engine.M)):
            raise ValueError(f"discipline {discipline!r} does not "
                             f"partition the {self.engine.M} blocks")
        self.timing_profile = timing if timing is not None else CostProfile()
        self.timing_only = compute == "timing"
        # record_z=False keeps only the O(T) live version window per
        # block server (plus the final z) — the long-training mode;
        # record_z=True retains the full per-version trajectory for
        # replay-parity pins and analysis
        self.record_z = record_z and not self.timing_only
        self.seed = spec.seed if seed is None else seed
        # Assumption 3's T: the session's delay model already carries it
        # (ring depth D+1) — the enforcer guarantees the runtime never
        # serves staler, so its trace replays within the same depth
        self.bound = (spec.delay_model.depth - 1 if staleness_bound is None
                      else int(staleness_bound))
        self.faults = faults.validate(self.engine.N, self.engine.M) \
            if faults is not None else None
        if self.faults is not None and self.faults.has_server_crash:
            raise NotImplementedError(DURABILITY_TODO)
        # divergence watchdog: halt the run (FloatingPointError naming
        # the round/block) the moment a committed z goes NaN/Inf
        self.check_finite = bool(check_finite) and not self.timing_only
        # telemetry (repro_torch.obs): None = inert — rt.obs is None and no
        # instrumentation site does anything; on = spans/stream record
        # in virtual time only, never perturbing the schedule
        self.obs = as_telemetry(telemetry)
        if metrics_every is not None:
            if self.obs is None:
                raise ValueError("metrics_every= needs telemetry= "
                                 "(the per-round stream cadence)")
            if metrics_every < 1:
                raise ValueError(f"metrics_every must be >= 1; "
                                 f"got {metrics_every}")
            self.obs.metrics_every = int(metrics_every)
        self._fixed_data = data
        self._batches = batches
        if not self.timing_only and data is None and batches is None:
            raise ValueError("compute='real' needs fixed per-worker data "
                             "or a batches(t) callable")
        if self.timing_only and self.engine.needs_grads_for_select():
            raise ValueError(
                "this block selector may read gradient norms "
                "(gauss_southwell / custom policies); run the PS runtime "
                "with compute='real', or pick a gradient-free selector "
                "(random/cyclic/zipf) for timing studies)")

    # ------------------------------------------------------------------
    def run(self, num_rounds: int, z0=None, *,
            checkpoint_every: Optional[int] = None,
            checkpoint_dir: Optional[str] = None,
            resume_from: Optional[str] = None) -> PSRunResult:
        """Drive ``num_rounds`` rounds. The durability knobs
        (``checkpoint_every``, ``checkpoint_dir``, ``resume_from``) keep
        the reference's signature and raise ``NotImplementedError``
        until that layer is ported."""
        if (checkpoint_every is not None or checkpoint_dir is not None
                or resume_from is not None):
            raise NotImplementedError(DURABILITY_TODO)
        if num_rounds < 1:
            raise ValueError("num_rounds must be >= 1")
        eng = self.engine
        self.num_rounds = num_rounds
        self.sched = EventScheduler()
        self.enforcer = StalenessEnforcer(self.bound)
        if self.obs is not None:
            self.sched.observer = self.obs.on_event
            self.enforcer.obs = self.obs
        self.trace = DelayTrace.empty(num_rounds, eng.N, eng.M, self.bound,
                                      self.discipline)
        self.worker_service = self.timing_profile.worker_service()
        self.net = self.timing_profile.network()
        self._losses = [[] for _ in range(num_rounds)] \
            if not self.timing_only else None
        self._data_cache: Dict[int, Any] = {}
        self._data_refs: Dict[int, int] = {}

        # --- chaos + elastic membership ---
        self.injector = FaultInjector(self.faults, self)
        cold = self.faults.cold_workers if self.faults is not None \
            else frozenset()
        self.membership = MembershipManager(eng.N, num_rounds, cold=cold)
        elastic = self.faults is not None and bool(self.faults.events)

        # --- unreliable transport (inert unless a knob or fault turns
        # loss on: reliable runs keep the exact pre-transport paths) ---
        raw_net = self.timing_profile.net
        base_tr = raw_net if isinstance(raw_net, Transport) else None
        lossy_faults = self.faults is not None and self.faults.has_link_loss
        if base_tr is not None and (base_tr.unreliable or lossy_faults):
            self.transport = base_tr
        elif lossy_faults:
            # link_loss bursts need the ack/retry layer even when the
            # base network is reliable — synthesize a zero-knob
            # Transport carrying the base latency model
            self.transport = Transport(
                latency=self.net.latency if self.net else 0.0,
                jitter=self.net.jitter if self.net else 0.0)
        else:
            self.transport = None
        self.fabric = None
        if self.transport is not None:
            recorder = self.trace.add_transport
            if self.obs is not None:
                # every delivery decision also lands as a span instant
                # (same kind spellings — obs.names is one registry)
                recorder = self.obs.transport_recorder(recorder)
            self.fabric = TransportFabric(
                self.transport, self.sched, self.seed,
                recorder=recorder,
                burst_drop=self.injector.link_drop
                if not self.injector.empty else None)

        # --- numeric state (Algorithm 1 lines 1-2) ---
        if self.timing_only:
            self.y = self.w = self.x = None
            contents0 = {j: None for j in range(eng.M)}
            caches0 = {}
        else:
            z0r, self.y, self.w, self.x = eng.init(z0)
            contents0 = dict(enumerate(eng.split_blocks(z0r)))
            caches0 = {j: eng.block_cache(self.w, j) for j in range(eng.M)}

        # --- lock domains per the coordination discipline ---
        commit_service = self.timing_profile.server_service()
        self.domains: List[BlockServerProc] = []
        for sid, block_ids in enumerate(self.groups):
            edge_workers = frozenset(
                i for i in range(eng.N)
                if any(eng.edge[i, j] for j in block_ids))
            self.domains.append(BlockServerProc(
                sid, block_ids, engine=eng, sched=self.sched,
                enforcer=self.enforcer, commit_service=commit_service,
                push_cost=self.timing_profile.t_push,
                rng=np.random.default_rng([self.seed, sid]),
                num_rounds=num_rounds, edge_workers=edge_workers,
                contents0={j: contents0[j] for j in block_ids},
                caches0={j: caches0[j] for j in block_ids}
                if not self.timing_only else {},
                timing_only=self.timing_only, per_push=self.per_push,
                membership=self.membership if elastic else None,
                fault_factor=self.injector.server_factor
                if not self.injector.empty else None,
                runtime=self))
        self.domain_of_block = [None] * eng.M
        for dom in self.domains:
            for j in dom.block_ids:
                self.domain_of_block[j] = dom
        self.domains_of_worker = [
            [dom for dom in self.domains if i in dom.edge_workers]
            for i in range(eng.N)]

        # --- launch ---
        workers = self._workers = [WorkerProc(i, self, cold=i in cold)
                                   for i in range(eng.N)]
        if self.obs is not None:
            self.obs.bind(num_domains=len(self.domains),
                          num_rounds=num_rounds,
                          record_fn=self._round_record)
        self._register_metrics()
        self.injector.install()
        for wk in workers:
            if wk.alive:
                self.sched.at(0.0, wk.start)
        for dom in self.domains:
            # blocks with an empty edge neighborhood still commit
            # every round (prox-only decay, as the epoch does)
            self.sched.at(0.0, dom._maybe_commit)
        makespan = self.sched.run()

        # --- invariants ---
        for wk in workers:
            expect = self.membership.participated_rounds(wk.i)
            if wk.rounds_done != expect:
                raise RuntimeError(f"worker {wk.i} finished "
                                   f"{wk.rounds_done}/{expect} participated "
                                   f"rounds — runtime deadlock?")
        for dom in self.domains:
            if dom.version != num_rounds:
                raise RuntimeError(f"lock domain {dom.sid} committed "
                                   f"{dom.version}/{num_rounds} versions")
        self.trace.set_participation(self.membership.participation_matrix())
        self.trace.validate()
        assert self.enforcer.idle

        z_final = None
        z_versions = None
        losses = None
        if not self.timing_only:
            to_user = eng.space.to_user

            def z_at(v):
                return to_user(eng.join_blocks(
                    [self.domain_of_block[j].content_at(j, v)
                     for j in range(eng.M)]))
            if self.record_z:
                z_versions = [z_at(v) for v in range(num_rounds + 1)]
            z_final = z_versions[-1] if z_versions else z_at(num_rounds)
            # mean over the round's PARTICIPANTS (all workers when
            # fault-free); a round everyone missed reports nan
            losses = [float(np.mean(l)) if l else float("nan")
                      for l in self._losses]

        # assemble the final metrics dict from the registry — the
        # instruments every component registered in _register_metrics
        # evaluate lazily here, in registration order, reproducing the
        # pre-telemetry dict byte for byte
        metrics = self.registry.collect()
        self.trace.meta.update(
            seed=self.seed, makespan=makespan,
            discipline=self.discipline,
            minibatch=self.spec.minibatch,
            net_latency=self.net.latency if self.net else 0.0,
            net_jitter=self.net.jitter if self.net else 0.0,
            stall_count=metrics["stall_count"],
            max_served_tau=metrics["max_served_tau"])
        if elastic:
            self.trace.meta.update(
                fault_events=len(self.faults.events),
                crashes=self.membership.crashes,
                rejoins=self.membership.rejoins)
        if self.transport is not None:
            tstats = metrics["transport"]
            self.trace.meta.update(transport={
                "drop_rate": self.transport.drop_rate,
                "dup_rate": self.transport.dup_rate,
                "reorder_rate": self.transport.reorder_rate,
                "ack_timeout": self.transport.ack_timeout,
                **{k: tstats[k] for k in
                   ("sent", "delivered", "drops", "dups", "reorders",
                    "retransmits", "dups_dropped", "timeout_fallbacks",
                    "delivery_rate")}})
        if self.obs is not None:
            self.obs.finalize({"seed": self.seed, "makespan": makespan,
                               "discipline": self.discipline,
                               "num_rounds": num_rounds})
        return PSRunResult(makespan=makespan, num_rounds=num_rounds,
                           discipline=self.discipline, trace=self.trace,
                           z_final=z_final, z_versions=z_versions,
                           losses=losses, metrics=metrics,
                           telemetry=self.obs)

    # ------------------------------------------------------------------
    # observability (repro_torch.obs)
    # ------------------------------------------------------------------
    def _register_metrics(self) -> None:
        """Build the run's :class:`~repro_torch.obs.MetricsRegistry`: every
        component registers lazy instruments over its own counters (no
        hot-path writes), and registration order IS the key order of
        the final ``PSRunResult.metrics`` dict — kept identical to the
        pre-registry inline assembly (byte-compatible)."""
        reg = self.registry = MetricsRegistry()
        self.enforcer.register_metrics(reg)
        reg.gauge("makespan", lambda: self.sched.now)
        reg.counter("events", lambda: self.sched.events_processed)
        BlockServerProc.register_metrics(reg, self.domains, self.sched)
        WorkerProc.register_metrics(reg, self)
        reg.histogram("histograms", lambda: {
            "worker_stall_time": hist(
                [self.enforcer.stall_time_by_worker.get(i, 0.0)
                 for i in range(self.engine.N)]),
            "server_occupancy": hist(
                [d.busy_time / self.sched.now if self.sched.now > 0
                 else 0.0 for d in self.domains])})
        if self.fabric is not None:
            self.fabric.register_metrics(reg, self)

    def _round_record(self, version: int, now: float) -> Dict[str, Any]:
        """One per-round stream record (obs/stream.py schema), built
        the moment the LAST lock domain published ``version`` — pure
        reads of committed state and monotone counters (no rng, no
        events: telemetry-on stays bitwise-identical)."""
        r = version - 1
        loss = None
        if self._losses is not None and self._losses[r]:
            loss = float(np.mean(self._losses[r]))
        depth = [int(sum(d._unprocessed.values())) for d in self.domains]
        record = {
            "round": r, "version": version, "sim_time": float(now),
            "loss": loss,
            "stationarity": self._round_stationarity(version),
            "queue_depth": depth,
            "commits": int(sum(d.commits for d in self.domains)),
            "pushes": int(sum(d.pushes for d in self.domains)),
            "stall_count": int(self.enforcer.stall_count),
            "stall_time": float(self.enforcer.stall_time),
            "transport": None}
        if self.fabric is not None:
            s = self.fabric.stats()
            record["transport"] = {
                k: int(s[k]) for k in ("sent", "delivered", "drops",
                                       "dups", "reorders", "retransmits")}
        spans = self.obs.spans if self.obs is not None else None
        if spans is not None:
            for dom, q in zip(self.domains, depth):
                spans.counter(self.obs.server_track(dom.sid),
                              "queue_depth", now, depth=q)
        return record

    def _round_stationarity(self, version: int) -> Optional[Dict]:
        """Per-block stationarity/residuals at a committed version
        (``core.metrics.block_residuals`` over the packed state), or
        None when not computable without perturbing the run: timing
        mode or ``track_x=False`` sessions. The
        gradient term needs fixed full-batch data (``batches=`` streams
        and minibatch draws are round-scoped); without it the streamed
        P carries the primal + prox terms only. The residuals are
        reduced on the device and copied to the host once per record."""
        if self.timing_only or getattr(self.x, "ndim", 0) != 3:
            return None
        from ..core.metrics import block_residuals
        eng = self.engine
        try:
            z = eng.join_blocks([
                self.domain_of_block[j].content_at(j, version)
                for j in range(eng.M)])
        except KeyError:
            return None                # version pruned
        grads = None
        if self._fixed_data is not None and self.spec.minibatch is None:
            _, grads, _ = eng.grads(self.x, self._fixed_data)
        res = block_residuals(z, self.y, self.x, self.spec.edge,
                              self.spec.rho_vec, reg=self.spec.reg,
                              grads=grads)
        primal = res["primal"].cpu().tolist()
        prox = res["prox"].cpu().tolist()
        grad = [] if res["grad"] is None else res["grad"].cpu().tolist()
        p_blocks = res["P"].cpu().tolist()
        return {
            "P": float(sum(p_blocks)),
            "primal_residual": float(np.sqrt(sum(v * v for v in primal))),
            "prox_residual": float(np.sqrt(sum(v * v for v in prox))),
            "grad_norm": (float(np.sqrt(sum(v * v for v in grad)))
                          if grad else None),
            "per_block": {"primal": primal, "prox": prox, "grad": grad,
                          "P": p_blocks}}

    # ------------------------------------------------------------------
    def worker_proc(self, i: int) -> WorkerProc:
        """Routing handle for server->worker messages (transport mode)."""
        return self._workers[i]

    # ------------------------------------------------------------------
    # chaos transitions (driven by the FaultInjector's scheduled events)
    # ------------------------------------------------------------------
    def _crash_worker(self, i: int, permanent: bool = False) -> None:
        wk = self._workers[i]
        if not wk.alive or wk.t >= self.num_rounds:
            return                     # already down / already finished
        r = wk.t                       # the round it never declared
        wk.kill()
        self.membership.deactivate(i, r)
        self.enforcer.drop_worker(i)
        if self.transport is not None:
            # pending pull requests died with the incarnation; clearing
            # the servers' dedup state lets a revived worker's
            # re-request for the same round be served as new
            for dom in self.domains:
                dom.forget_pending_pulls(i)
        kind = "leave" if permanent else "crash"
        self.trace.add_event(kind, worker=i, round=r, time=self.sched.now)
        if self.obs is not None:
            track = self.obs.worker_track(i)
            if self.obs.spans is not None:
                self.obs.spans.instant(track, kind, self.sched.now,
                                       round=r)
            self.obs.entity_down(track, self.sched.now)
        # gates waiting on this worker's declaration must re-check
        for dom in self.domains_of_worker[i]:
            dom._maybe_commit()
        self._maybe_evict_data(r)

    def _rejoin_worker(self, i: int, cold: bool = False) -> None:
        wk = self._workers[i]
        if wk.alive:
            return                     # crash was a no-op (already done)
        doms = self.domains_of_worker[i]
        # service frontier: one past the newest version any edge domain
        # has committed OR is committing — strictly-future gates only,
        # so resumption never races an in-flight commit whose gate
        # already passed without this worker
        frontier = max((d.version + (1 if d._committing else 0)
                        for d in doms), default=0)
        r = max(wk.t, frontier + 1)
        kind = "join" if cold else "rejoin"
        if r >= self.num_rounds:
            # nothing left to participate in — stays absent to the end
            self.trace.add_event(kind, worker=i, round=None,
                                 time=self.sched.now, effective=False)
            return
        self.membership.activate(i, r)
        self.enforcer.note_rejoin()
        self.trace.add_event(kind, worker=i, round=r, time=self.sched.now)
        if self.obs is not None:
            track = self.obs.worker_track(i)
            if self.obs.spans is not None:
                self.obs.spans.instant(track, kind, self.sched.now,
                                       round=r)
            self.obs.entity_up(track, self.sched.now)
        wk.revive(r)

    # ------------------------------------------------------------------
    # per-round data (minibatched through the epoch's key chain)
    # ------------------------------------------------------------------
    def data_for(self, t: int):
        if t not in self._data_cache:
            base = self._batches(t) if self._batches is not None \
                else self._fixed_data
            self._data_cache[t] = self.engine.round_data(t, base)
            self._data_refs[t] = 0
        return self._data_cache[t]

    def data_done(self, t: int) -> None:
        if t in self._data_refs:
            self._data_refs[t] += 1
            self._maybe_evict_data(t)

    def _expected_consumers(self, t: int) -> int:
        return sum(1 for i in range(self.engine.N)
                   if self.membership.required(i, t))

    def _maybe_evict_data(self, t: int) -> None:
        if t in self._data_refs \
                and self._data_refs[t] >= self._expected_consumers(t):
            del self._data_cache[t]
            del self._data_refs[t]

    def record_loss(self, t: int, i: int, loss) -> None:
        """One host copy per worker compute (``loss`` is worker i's
        0-d loss tensor)."""
        self._losses[t].append(float(loss))

    def on_worker_progress(self) -> None:
        """A worker advanced a round: without full-trajectory recording,
        drop block versions no worker can legally read anymore
        (< min worker round - T). Absent workers resume at one past the
        newest committed version, so counting ``1 + max version`` for
        them keeps every version a future rejoiner could read."""
        if self.record_z or self.timing_only:
            return
        live = [wk.t for wk in self._workers if wk.alive]
        if len(live) < len(self._workers):
            live.append(1 + max(d.version for d in self.domains))
        thr = min(live) - self.bound
        if thr > 0:
            for dom in self.domains:
                dom.prune(thr)
