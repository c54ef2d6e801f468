"""Worker processes — pull, compute, declare/push, repeat.

Each worker runs Algorithm 1's lines 3-9 as an event-driven cycle:

  1. **pull**  — request every lock domain's freshest committed version
     (capped at its own round t, as the epoch model reads versions
     <= t). Pulls route through the :class:`StalenessEnforcer`: a
     domain lagging more than T versions stalls the worker until the
     commit that restores Assumption 3. With a
     :class:`~repro_torch.ps.timing.NetworkModel` on the cost profile, each
     served pull's *response* additionally travels ``net.sample()``
     simulated seconds before the worker sees it (the version is fixed
     at serve time), and each round's declaration/push bundle travels
     the same way back — latency shifts what the trace records, never
     whether it replays.
  2. **compute** — once every pull resolves, the observed staleness row
     is recorded into the :class:`DelayTrace` and the worker's service
     time elapses (the scheduler's clock; stragglers come from the
     timing model, transient chaos slowdowns multiply the draw). The
     numerics — the REAL ``worker_grads`` + ``worker_select_update``
     (on the card: the B1 kernel) at the epoch's full shape with this
     worker's row live — run at completion.
  3. **declare/push** — the selection row (the epoch's selector on the
     epoch's key chain) decides which blocks get fresh w pushes; every
     edge domain gets a declaration either way.

In ``timing_only`` mode step 2 skips the numerics (selection still
runs — it shapes server load) so coordination scalability can be
simulated at sizes where real gradients would dominate wall-clock.

Elasticity: a worker can die mid-cycle (:meth:`kill`) and resume later
(:meth:`revive`) at the round the membership manager hands it. Death
bumps an **incarnation counter**; every event the worker schedules
(compute completions, delayed pull responses, declaration deliveries
already in flight are fine — they belong to completed rounds) is
guarded on the incarnation it was scheduled under, so a dead
incarnation's events no-op instead of corrupting the resumed cycle.
The worker's y row and its w~ rows on the servers stay stale across
the outage until its first post-resume declare — exactly the frozen
rows the epoch's partial-participation mask reproduces on replay.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class WorkerProc:
    def __init__(self, i: int, runtime, *, cold: bool = False):
        self.i = i
        self.rt = runtime
        self.rng = np.random.default_rng([runtime.seed, 1000 + i])
        self.t = 0
        self.rounds_done = 0
        self.alive = not cold
        self.gen = 0                   # incarnation counter
        self._pulled = {}
        # block id -> content grabbed when its pull resolved: the pull
        # response carries the payload (as a real protocol's would), so
        # a block server crashing between the response and this round's
        # compute cannot take the read back with it
        self._vals = {}
        self._pending = 0
        self._issued = False
        # unreliable-transport state: last committed version observed per
        # domain (the graceful-degradation fallback read), and the
        # (domain, round) declare bundles the server has acked. Both
        # survive kill/revive: the cache is still a legally committed
        # version, and completed rounds' declares must keep deduping.
        self._cache = {}
        self._acked = set()
        # telemetry anchors (records of times the schedule already
        # chose — never inputs to it): round pull-issue time, compute
        # start time
        self._issue_time = 0.0
        self._compute_start = 0.0

    # ---- elasticity -------------------------------------------------------
    def kill(self) -> None:
        """Crash/leave: invalidate every in-flight event of this
        incarnation (the enforcer separately drops parked pulls)."""
        self.alive = False
        self.gen += 1
        self._pulled = {}
        self._vals = {}
        self._pending = 0
        self._issued = False

    def revive(self, t: int) -> None:
        """Resume the cycle at round ``t`` (the membership manager's
        service frontier). Fresh z comes from the first pulls; y/w~
        stay whatever the last completed round left."""
        self.alive = True
        self.gen += 1
        self._begin_round(t)

    def _guarded(self, fn):
        gen = self.gen

        def run(*args):
            if self.alive and self.gen == gen:
                fn(*args)
        return run

    # ---- the cycle --------------------------------------------------------
    def start(self) -> None:
        self._begin_round(0)

    def _begin_round(self, t: int) -> None:
        self.t = t                     # finished workers report t == R
        if t >= self.rt.num_rounds:
            return
        self._pulled = {}
        self._vals = {}
        self._issued = False
        self._pending = len(self.rt.domains)
        self._issue_time = self.rt.sched.now
        net = self.rt.net
        for dom in self.rt.domains:
            if self.rt.transport is not None:
                # lossy link: request/response with ack-by-response,
                # timeout + backoff retransmission, cache fallback
                self._pull_attempt(dom, t, 0)
                continue
            if net is None:
                resolve = (lambda version, dom=dom:
                           self._on_pull(dom, version))
            else:
                # the enforcer fixes the served version NOW; the response
                # then spends a network-latency sample in flight (guarded:
                # a response landing on a dead incarnation is dropped)
                def resolve(version, dom=dom):
                    self.rt.sched.after(
                        net.sample(self.rng),
                        self._guarded(lambda: self._on_pull(dom, version)))
            self.rt.enforcer.request(dom, t, self.rt.sched.now, resolve,
                                     worker=self.i)
        self._issued = True
        if self._pending == 0:
            self._start_compute()

    def _on_pull(self, dom, version: int, payload=None) -> None:
        self._pulled[dom.sid] = version
        obs = self.rt.obs
        if obs is not None and obs.spans is not None:
            # pull RTT: issue -> version in hand (stalls, network
            # latency and retransmission ladders all inside the span)
            obs.spans.complete(obs.worker_track(self.i), "pull",
                               self._issue_time, self.rt.sched.now,
                               round=self.t, domain=dom.sid,
                               version=version, tau=self.t - version)
        if not self.rt.timing_only:
            # grab the payload NOW (transport responses deliver it;
            # direct serves read the committed store, which is immutable
            # per version) — see the _vals contract above
            if payload is None:
                payload = [dom.content_at(j, version)
                           for j in dom.block_ids]
            for j, val in zip(dom.block_ids, payload):
                self._vals[j] = val
        if self.rt.transport is not None:
            self._cache[dom.sid] = max(self._cache.get(dom.sid, 0), version)
        self._pending -= 1
        if self._issued and self._pending == 0:
            self._start_compute()

    # ---- unreliable-transport pull cycle ----------------------------------
    def _pull_attempt(self, dom, t: int, retry: int) -> None:
        ch = self.rt.fabric.link(self.i, dom)
        if retry > 0:
            ch.note_retransmit("pull_req", t, retry)
        ch.send(lambda: dom.on_pull_request(self.i, t),
                msg="pull_req", t=t)
        self.rt.sched.after(
            self.rt.transport.timeout(retry),
            self._guarded(lambda: self._pull_retry(dom, t, retry)))

    def _pull_retry(self, dom, t: int, retry: int) -> None:
        """Retransmission timer fired: resend unless the pull resolved
        meanwhile. After ``max_retries`` the worker degrades gracefully
        to its cached version — IF that read still satisfies
        Assumption 3's tau <= bound; a cache too stale to be legal keeps
        retransmitting (the server must catch up eventually, and the
        bounded-staleness stall is exactly what the theory expects)."""
        if self.t != t or self._pending == 0 or dom.sid in self._pulled:
            return
        tr = self.rt.transport
        cached = self._cache.get(dom.sid, 0)
        if retry >= tr.max_retries and t - cached <= self.rt.enforcer.bound:
            ch = self.rt.fabric.link(self.i, dom)
            ch.note_timeout("pull_req", t, cached)
            self.rt.enforcer.fallback(t, cached, worker=self.i)
            self._on_pull(dom, cached)
            return
        self._pull_attempt(dom, t, retry + 1)

    def on_pull_response(self, dom, t: int, version: int,
                         payload=None) -> None:
        """A pull response landed off the link (possibly late, possibly
        a duplicate, possibly for a round this incarnation already left
        behind) — only the first response for the CURRENT round's
        outstanding pull resolves it. ``payload`` is the block contents
        the response carried (None in timing-only mode)."""
        if (not self.alive or self.t != t or self._pending == 0
                or dom.sid in self._pulled):
            return
        self._on_pull(dom, version, payload)

    # ---- unreliable-transport declare cycle -------------------------------
    def _declare_reliably(self, dom, t: int, pushes: list,
                          retry: int = 0) -> None:
        """Send the round-t declaration bundle until the server acks it.
        Deliberately NOT incarnation-guarded and NOT retry-capped: the
        round already completed, so its declaration must eventually
        reach the commit gate (required gates would deadlock otherwise)
        even if this worker dies in the meantime; the gate's
        (worker, round) dedup makes every retransmit fold zero times
        after the first arrival."""
        if (dom.sid, t) in self._acked:
            return
        ch = self.rt.fabric.link(self.i, dom)
        if retry > 0:
            ch.note_retransmit("declare", t, retry)
        ch.send(lambda: dom.on_declare_msg(self.i, t, pushes),
                msg="declare", t=t)
        self.rt.sched.after(
            self.rt.transport.timeout(retry),
            lambda: self._declare_reliably(dom, t, pushes, retry + 1))

    def on_declare_ack(self, dom, t: int) -> None:
        self._acked.add((dom.sid, t))

    def _start_compute(self) -> None:
        t = self.t
        rt = self.rt
        # observed staleness row -> the trace (replayable via TraceDelay)
        row = np.empty(rt.engine.M, np.int32)
        for j in range(rt.engine.M):
            row[j] = t - self._pulled[rt.domain_of_block[j].sid]
        rt.trace.record(t, self.i, row)
        contents: Optional[list] = None
        if not rt.timing_only:
            # the payloads grabbed as each pull resolved (_vals): the
            # versions pinned in self._pulled, immune to a block server
            # crashing between its response and this compute start
            contents = [self._vals[j] for j in range(rt.engine.M)]
        dur = rt.worker_service.sample(self.rng)
        dur *= rt.injector.worker_factor(self.i, rt.sched.now)
        self._compute_start = rt.sched.now
        rt.sched.after(dur, self._guarded(
            lambda: self._finish_round(t, contents)))

    def _finish_round(self, t: int, contents) -> None:
        rt, i = self.rt, self.i
        eng = rt.engine
        obs = rt.obs
        if obs is not None and obs.spans is not None:
            # emitted at completion so a mid-compute crash leaves no
            # phantom span (the guarded event never fires)
            obs.spans.complete(obs.worker_track(i), "compute",
                               self._compute_start, rt.sched.now,
                               round=t)
        if rt.timing_only:
            sel_row = eng.select(t, i, None)
        else:
            z_buf = eng.z_tilde_buffer(i, contents)
            data = rt.data_for(t)
            losses, g_buf, gnorm = eng.grads(z_buf, data)
            rt.record_loss(t, i, losses[i])
            sel_row = eng.select(
                t, i, gnorm[i] if eng.needs_grads_for_select() else None)
            rt.y, rt.w, rt.x = eng.update(
                i, g_buf, z_buf, rt.y, rt.w, rt.x, sel_row)
        # declare to every edge domain; push fresh w where selected (the
        # declaration + its pushes travel as ONE message, so a round's
        # pushes never overtake their own declaration under latency;
        # deliveries stay valid even if the worker dies after sending —
        # the round completed, so they are NOT incarnation-guarded)
        sel_row = sel_row & eng.edge[i]        # numpy: select's row
        for dom in rt.domains_of_worker[i]:
            pushes = [(j, None if rt.timing_only
                       else eng.push_value(rt.w, i, j))
                      for j in dom.block_ids if sel_row[j]]
            if rt.transport is not None:
                self._declare_reliably(dom, t, pushes)
            elif rt.net is None:
                dom.on_declare(i, t, pushes)
            else:
                rt.sched.after(rt.net.sample(self.rng),
                               lambda dom=dom, pushes=pushes:
                               dom.on_declare(i, t, pushes))
        self.rounds_done += 1
        rt.data_done(t)
        self._begin_round(t + 1)
        rt.on_worker_progress()

    # ---- telemetry --------------------------------------------------------
    @staticmethod
    def register_metrics(reg, rt) -> None:
        """Register the worker/membership instruments into the run's
        :class:`~repro_torch.obs.MetricsRegistry`."""
        enforcer, membership, N = rt.enforcer, rt.membership, rt.engine.N
        reg.gauge("stall_time_per_worker",
                  lambda: [enforcer.stall_time_by_worker.get(i, 0.0)
                           for i in range(N)])
        reg.gauge("stall_count_per_worker",
                  lambda: [enforcer.stall_count_by_worker.get(i, 0)
                           for i in range(N)])
        reg.gauge("participated_rounds",
                  lambda: [membership.participated_rounds(i)
                           for i in range(N)])
        reg.counter("worker_iterations",
                    lambda: sum(membership.participated_rounds(i)
                                for i in range(N)))
        reg.counter("crashes", lambda: membership.crashes)
        reg.counter("rejoins", lambda: membership.rejoins)
