"""Service-time models for the PS runtime + measured kernel costs.

The discrete-event scheduler charges every worker compute and every
server commit a service time drawn from a :class:`ServiceModel`:

* ``constant``  — deterministic (CI gates, analytical checks);
* ``lognormal`` — the seed benchmark's EC2-style jitter;
* ``pareto``    — heavy-tailed stragglers (the cluster profile behind
  the paper's Table-1 story and our ``ParetoDelay`` staleness model).

:class:`NetworkModel` (``CostProfile(net=...)``) additionally charges a
constant + jitter latency on every worker<->server message — pull
responses and declaration/push bundles — so coordination studies can
separate compute stragglers from network lag. Observed staleness still lands
in the ``DelayTrace``, so replay parity holds under any network model.

:func:`measure_costs` grounds the simulation in reality: it times the
REAL ``VariableSpace`` hot-path ops through :class:`SpaceEngine` (the
same ``worker_grads`` / ``worker_select_update`` /
``server_consensus_update`` the epoch runs, so on the card the worker
update and the commit are the B1 and B2 kernels) on the spec's device
and returns per-event seconds for a :class:`CostProfile`.
"""
from __future__ import annotations

import dataclasses
import time as _time
from typing import Any, Dict, Optional, Protocol

import numpy as np


class ServiceModel(Protocol):
    """Draws one service duration from an entity-owned generator."""

    def sample(self, rng: np.random.Generator) -> float: ...


@dataclasses.dataclass(frozen=True)
class ConstantService:
    """Deterministic service time (the CI-gate workhorse)."""
    mean: float

    def sample(self, rng: np.random.Generator) -> float:
        return self.mean


@dataclasses.dataclass(frozen=True)
class LognormalService:
    """``mean * LogNormal(0, sigma)`` — the seed benchmark's jitter."""
    mean: float
    sigma: float = 0.3

    def sample(self, rng: np.random.Generator) -> float:
        return self.mean * float(rng.lognormal(0.0, self.sigma))


@dataclasses.dataclass(frozen=True)
class ParetoService:
    """Heavy-tailed straggler service: ``mean * X`` with X ~ Pareto
    (x_m = 1, tail ``alpha``), mean-normalized when ``alpha > 1`` and
    capped at ``cap`` multiples of the mean so a single draw cannot
    dominate the makespan unboundedly."""
    mean: float
    alpha: float = 1.2
    cap: float = 50.0

    def sample(self, rng: np.random.Generator) -> float:
        x = (1.0 - float(rng.random())) ** (-1.0 / self.alpha)
        if self.alpha > 1.0:
            x *= (self.alpha - 1.0) / self.alpha
        return self.mean * min(x, self.cap)


SERVICE_MODELS = {"constant": ConstantService, "lognormal": LognormalService,
                  "pareto": ParetoService}


def as_service(v) -> ServiceModel:
    """Coerce a float to ConstantService; pass ServiceModels through.

    Constants are validated eagerly: a negative or non-finite service
    time would silently run the scheduler's clock backwards (``after``
    rejects negative delays only at event time, deep inside a run), so
    it fails here with an actionable message instead."""
    if hasattr(v, "sample"):
        return v
    t = float(v)
    if not np.isfinite(t) or t < 0.0:
        raise ValueError(
            f"as_service: constant service time must be finite and >= 0 "
            f"(simulated seconds per event); got {v!r} — fix the "
            f"CostProfile field (t_worker / t_server_block), or pass a "
            f"ServiceModel for stochastic draws")
    return ConstantService(t)


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Per-message network latency between workers and block servers:
    ``latency`` + U(-jitter, +jitter), floored at 0.

    Charged once per worker<->server message — each pull *response*
    (server -> worker, after the enforcer serves it) and each
    declaration/push bundle (worker -> server). Latency shifts WHEN
    messages land (and therefore which versions later pulls observe and
    how long commits wait on declarations), but every observed
    staleness row is still recorded into the ``DelayTrace`` at compute
    time, so trace replay through ``asybadmm_epoch`` stays exact — the
    network model changes the trace, never the replay contract."""
    latency: float
    jitter: float = 0.0

    def __post_init__(self):
        if self.latency < 0.0 or self.jitter < 0.0:
            raise ValueError(f"network latency/jitter must be >= 0; got "
                             f"latency={self.latency} jitter={self.jitter}")

    def sample(self, rng: np.random.Generator) -> float:
        if self.jitter <= 0.0:
            return self.latency
        return max(0.0, self.latency
                   + self.jitter * (2.0 * float(rng.random()) - 1.0))


@dataclasses.dataclass(frozen=True)
class Transport(NetworkModel):
    """An *unreliable* network between workers and block servers.

    Extends :class:`NetworkModel` (constant + jitter latency per
    message) with per-link delivery faults, drawn from seeded per-link
    rngs so lossy runs stay exactly as deterministic and replayable as
    reliable ones:

    drop_rate    : probability a sent message is lost;
    dup_rate     : probability a delivered message arrives twice;
    reorder_rate : probability a delivered copy is held back an extra
                   U(0, reorder window) — enough to land after later
                   traffic on the same link;
    ack_timeout  : how long the sender waits for the response/ack
                   before retransmitting;
    max_retries  : pull retransmissions before the worker degrades
                   gracefully to its cached z (when that read still
                   satisfies Assumption 3's tau <= T); declarations
                   retransmit without bound — a round's pushes must
                   eventually commit;
    backoff      : exponential retransmission backoff multiplier,
                   capped at ``max_backoff`` timeouts;
    reorder_window : extra-delay window for reordered copies
                   (0.0 = one ack_timeout).

    With every fault knob at zero the transport is INERT: the runtime
    routes messages through the plain :class:`NetworkModel` path (or no
    network model at all), byte-identical to pre-transport behavior.
    The reliability machinery — sequence numbers, acks, retransmits,
    commit-gate dedup — engages only when a knob is on (or a
    ``link_loss`` fault window makes a link lossy mid-run).
    """
    drop_rate: float = 0.0
    dup_rate: float = 0.0
    reorder_rate: float = 0.0
    ack_timeout: float = 1.0
    max_retries: int = 3
    backoff: float = 2.0
    max_backoff: float = 8.0
    reorder_window: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        for name in ("drop_rate", "dup_rate", "reorder_rate"):
            p = getattr(self, name)
            if not (0.0 <= p < 1.0) or not np.isfinite(p):
                raise ValueError(
                    f"transport {name} must be a probability in [0, 1) "
                    f"(1.0 would never deliver); got {p}")
        if not np.isfinite(self.ack_timeout) or self.ack_timeout <= 0.0:
            raise ValueError(f"transport ack_timeout must be finite and "
                             f"> 0; got {self.ack_timeout}")
        if self.max_retries < 0:
            raise ValueError(f"transport max_retries must be >= 0; got "
                             f"{self.max_retries}")
        if not np.isfinite(self.backoff) or self.backoff < 1.0:
            raise ValueError(f"transport backoff multiplier must be >= 1; "
                             f"got {self.backoff}")
        if self.max_backoff < 1.0:
            raise ValueError(f"transport max_backoff must be >= 1 "
                             f"ack_timeout; got {self.max_backoff}")
        if self.reorder_window < 0.0:
            raise ValueError(f"transport reorder_window must be >= 0; got "
                             f"{self.reorder_window}")

    @property
    def unreliable(self) -> bool:
        """Whether any fault knob is on — the switch between the plain
        NetworkModel path and the ack/retry reliability sublayer."""
        return (self.drop_rate > 0.0 or self.dup_rate > 0.0
                or self.reorder_rate > 0.0)

    def timeout(self, retry: int) -> float:
        """Retransmission timeout for attempt ``retry`` (0-based):
        capped exponential backoff."""
        return self.ack_timeout * min(self.backoff ** retry,
                                      self.max_backoff)

    def reorder_extra(self, rng: np.random.Generator) -> float:
        window = self.reorder_window if self.reorder_window > 0.0 \
            else self.ack_timeout
        return window * float(rng.random())


def as_network(v) -> Optional[NetworkModel]:
    """None / 0.0 -> no network model; float -> constant latency;
    NetworkModel passes through (degenerate zero models drop to None so
    the zero-latency scheduler path stays byte-identical). An
    *unreliable* :class:`Transport` always passes through — loss alone
    engages the messaging layer even at zero latency."""
    if v is None:
        return None
    net = v if isinstance(v, NetworkModel) else NetworkModel(float(v))
    if isinstance(net, Transport) and net.unreliable:
        return net
    return net if (net.latency > 0.0 or net.jitter > 0.0) else None


@dataclasses.dataclass(frozen=True)
class CostProfile:
    """Per-event costs fed to the scheduler.

    t_worker       : one worker iteration (stale pull -> grad -> update);
    t_server_block : one block server commit (eq. 13 on one block); the
                     locked full-vector discipline pays it once per
                     block it holds under the lock;
    t_push         : server-side processing of one incoming w push
                     (queueing delay on the lock domain) — a plain
                     float, charged deterministically per push;
    net            : worker<->server network latency per message —
                     None (ideal network), a float (constant), a
                     :class:`NetworkModel` (constant + jitter), or a
                     :class:`Transport` (unreliable: drop / duplicate /
                     reorder with ack+retransmit reliability).
    ``t_worker`` / ``t_server_block`` floats coerce to
    ConstantService; pass a ServiceModel for jitter.
    """
    t_worker: Any = 1.0
    t_server_block: Any = 0.25
    t_push: float = 0.0
    net: Any = None

    def __post_init__(self):
        if hasattr(self.t_push, "sample"):
            raise TypeError("t_push is a deterministic float cost, not a "
                            "ServiceModel (push processing is charged per "
                            "event on the lock domain's queue)")

    def worker_service(self) -> ServiceModel:
        return as_service(self.t_worker)

    def server_service(self) -> ServiceModel:
        return as_service(self.t_server_block)

    def network(self) -> Optional[NetworkModel]:
        return as_network(self.net)


def measure_costs(spec, data, z0=None, *, repeats: int = 20
                  ) -> Dict[str, float]:
    """Time the real unified-path ops for one worker iteration and one
    block-server commit on the spec's device.

    Returns ``{"t_worker": s, "t_server_block": s}`` — seconds per
    event. The worker op executes at the epoch's full (N, ...) shape
    (that IS the hot path), so the per-worker cost is the measured call
    divided by N. On CUDA every call is bracketed by
    ``torch.cuda.synchronize()``, so the host clock reads device time,
    not the enqueue.
    """
    import torch

    from .engine import SpaceEngine

    eng = SpaceEngine(spec)
    z0r, y, w, x = eng.init(z0)
    contents = eng.split_blocks(z0r)
    data0 = eng.round_data(0, data)
    zbuf = eng.z_tilde_buffer(0, contents)
    gnorm0 = (torch.zeros(eng.M, dtype=torch.float32, device=eng.device)
              if eng.needs_grads_for_select() else None)
    sel_row = eng.select(0, 0, gnorm0)
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))

    def _timeit(fn, n):
        fn()                                   # build + warm
        sync()
        t0 = _time.perf_counter()
        for _ in range(n):
            fn()
            sync()
        return (_time.perf_counter() - t0) / n

    def worker_once():
        losses, g_buf, _ = eng.grads(zbuf, data0)
        return eng.update(0, g_buf, zbuf, y, w, x, sel_row)

    t_worker = _timeit(worker_once, repeats) / eng.N

    cache0 = eng.block_cache(w, 0)
    t_server = _timeit(lambda: eng.commit_block(0, contents[0], cache0),
                       max(repeats, 50))
    return {"t_worker": t_worker, "t_server_block": t_server}
