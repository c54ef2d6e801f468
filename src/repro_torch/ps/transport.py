"""Unreliable worker<->server links + the delivery bookkeeping.

One :class:`LinkChannel` per (worker, lock domain) pair simulates the
link both directions travel: every ``send`` draws the link's fate —
drop, duplicate, reorder hold-back, latency — from the link's OWN
seeded rng (``default_rng([seed, 3000 + worker, sid])``), so delivery
schedules are deterministic and independent of event interleaving,
exactly like every other draw in the DES runtime.

The reliability protocol built on top (in ``worker.py``/``server.py``)
is end-to-end:

* **pulls** — the request travels, the server fixes the served version
  (through the StalenessEnforcer) once per (worker, round) and replies;
  the *response is the ack*. The worker retransmits on timeout with
  capped exponential backoff; after ``max_retries`` it degrades
  gracefully to its cached z when that read still satisfies
  Assumption 3 (accounted by the enforcer as a timeout fallback — an
  extra staleness step, never a tau violation), else keeps retrying.
* **declarations/pushes** — the round bundle retransmits WITHOUT bound
  until the server acks it (a required round must eventually commit);
  the commit gate dedups by (worker, round), so retransmits and
  transport duplicates fold exactly once.

Every non-clean delivery decision (drop, duplicate, reorder slot,
retransmit, pull timeout) is recorded into the run's
:class:`~repro_torch.ps.trace.DelayTrace` transport log — the *effective
committed schedule* is what the trace's staleness + participation
matrices pin, so lossy runs replay through ``asybadmm_epoch`` exactly
like reliable ones; the log is for debugging the loss itself.

``link_loss`` fault windows (``ps/chaos.py``) add burst loss on top of
the base ``drop_rate``: at send time the channel asks the injector for
the window's drop probability and composes it with the base rate.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from .timing import Transport


class LinkChannel:
    """One worker<->domain link: seeded fate draws + delivery stats."""

    def __init__(self, transport: Transport, sched, rng: np.random.Generator,
                 worker: int, sid: int, block_ids,
                 recorder: Optional[Callable] = None,
                 burst_drop: Optional[Callable] = None):
        self.transport = transport
        self.sched = sched
        self.rng = rng
        self.worker = worker
        self.sid = sid
        self.block_ids = tuple(block_ids)
        self._record = recorder
        self._burst_drop = burst_drop
        self._seq = 0
        self.sent = 0
        self.delivered = 0
        self.drops = 0
        self.dups = 0
        self.reorders = 0
        self.retransmits = 0

    # ------------------------------------------------------------------
    def _note(self, kind: str, msg: str, t: int, **extra) -> None:
        if self._record is not None:
            self._record(kind, msg=msg, worker=self.worker, domain=self.sid,
                         round=t, time=self.sched.now, **extra)

    def _drop_rate(self) -> float:
        """Base drop rate composed with any active link_loss burst."""
        p = self.transport.drop_rate
        if self._burst_drop is not None:
            q = self._burst_drop(self.worker, self.block_ids, self.sched.now)
            if q > 0.0:
                p = 1.0 - (1.0 - p) * (1.0 - q)
        return p

    def send(self, deliver: Callable[[], None], *, msg: str, t: int) -> int:
        """Put one message on the link; returns its sequence number.
        Draws (in order): drop -> duplicate -> per-copy latency +
        reorder hold-back. A dropped message schedules nothing — the
        sender's retransmission timer is the only way it recovers."""
        tr = self.transport
        rng = self.rng
        seq = self._seq
        self._seq += 1
        self.sent += 1
        p_drop = self._drop_rate()
        if p_drop > 0.0 and float(rng.random()) < p_drop:
            self.drops += 1
            self._note("drop", msg, t, seq=seq)
            return seq
        copies = 1
        if tr.dup_rate > 0.0 and float(rng.random()) < tr.dup_rate:
            copies = 2
            self.dups += 1
            self._note("dup", msg, t, seq=seq)
        self.delivered += 1
        for c in range(copies):
            delay = tr.sample(rng)
            if tr.reorder_rate > 0.0 \
                    and float(rng.random()) < tr.reorder_rate:
                extra = tr.reorder_extra(rng)
                delay += extra
                self.reorders += 1
                self._note("reorder", msg, t, seq=seq, copy=c,
                           held=round(extra, 6))
            self.sched.after(delay, deliver)
        return seq

    def note_retransmit(self, msg: str, t: int, retry: int) -> None:
        self.retransmits += 1
        self._note("retransmit", msg, t, retry=retry)

    def note_timeout(self, msg: str, t: int, version: int) -> None:
        self._note("pull_timeout", msg, t, served_version=version)

    @property
    def delivery_rate(self) -> float:
        return self.delivered / self.sent if self.sent else 1.0


class TransportFabric:
    """All links of one run: lazy per-link channels + fleet-wide stats."""

    def __init__(self, transport: Transport, sched, seed: int,
                 recorder: Optional[Callable] = None,
                 burst_drop: Optional[Callable] = None):
        self.transport = transport
        self.sched = sched
        self.seed = seed
        self._recorder = recorder
        self._burst_drop = burst_drop
        self._links: Dict[tuple, LinkChannel] = {}

    def link(self, worker: int, dom) -> LinkChannel:
        key = (worker, dom.sid)
        ch = self._links.get(key)
        if ch is None:
            ch = self._links[key] = LinkChannel(
                self.transport, self.sched,
                np.random.default_rng([self.seed, 3000 + worker, dom.sid]),
                worker, dom.sid, dom.block_ids,
                recorder=self._recorder, burst_drop=self._burst_drop)
        return ch

    def stats(self) -> Dict:
        links = self._links.values()
        total = {k: sum(getattr(ch, k) for ch in links)
                 for k in ("sent", "delivered", "drops", "dups", "reorders",
                           "retransmits")}
        total["delivery_rate"] = (total["delivered"] / total["sent"]
                                  if total["sent"] else 1.0)
        total["per_link_delivery_rate"] = {
            f"w{w}->s{s}": round(ch.delivery_rate, 4)
            for (w, s), ch in sorted(self._links.items())}
        return total

    def register_metrics(self, reg, rt) -> None:
        """Register the fleet-wide transport instrument (delivery
        totals + the server/enforcer dedup and fallback counters that
        belong to the transport story)."""
        def value():
            s = self.stats()
            s["dups_dropped"] = sum(d.dups_dropped for d in rt.domains)
            s["timeout_fallbacks"] = rt.enforcer.timeout_fallbacks
            return s
        reg.gauge("transport", value)
