"""User-facing builder API for AsyBADMM in flat mode.

``ConsensusSession`` binds a :class:`~repro_torch.core.space.ConsensusSpec`
(space + policies) to an :class:`~repro_torch.configs.base.ADMMConfig`
and exposes init/step/run. It runs on the CUDA card unless the caller
passes ``device="cpu"``:

    from repro_torch.api import ConsensusSession, solve

    sess = ConsensusSession.flat(loss_fn, (X, y), dim=512, cfg=cfg,
                                 support=support)
    state, history = sess.run(600, eval_every=100)
    z = sess.z(state)

    # or, one call:
    z, history = solve(loss_fn, (X, y), dim=512, num_epochs=600, cfg=cfg)

    # or under the event-driven Parameter Server runtime:
    res = sess.run_ps(20, discipline="lockfree")

``loss_fn(z, worker_data)`` is written in torch; per-worker gradients
come from ``torch.func.vmap(grad_and_value(loss_fn))``.

With ``mesh=`` the session runs SPMD, one process per rank of an
initialised ``torch.distributed`` process group: every rank builds the
same session from the same full data and keeps only the rows it
differentiates, its state holds the rank's local tiles, and every
inspection method (``z``, ``objective``, the residual, P, the KKT
violations) gives the single-device number on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .configs.base import ADMMConfig
from .core.consensus import ConsensusProblem, make_problem
from .core.metrics import kkt_violations, stationarity
from .core.sharded import full_z_blocks
from .core.space import (ConsensusSpec, ConsensusState, asybadmm_epoch,
                         consensus_residual, init_consensus_state)
from .device import DeviceLike


@dataclasses.dataclass(frozen=True)
class ConsensusSession:
    """A configured AsyBADMM run: spec + config + fixed data.

    spec    : the generic step spec (space, edge, rho_vec, policies);
    cfg     : the ADMMConfig the spec was built from;
    data    : fixed per-worker data on the spec's device (on a mesh, this
              rank's rows); ``step`` falls back to it when no batch is
              passed;
    problem : the flat-mode ConsensusProblem — kept so the objective and
              the stationarity/KKT metrics stay available.
    """
    spec: ConsensusSpec
    cfg: ADMMConfig
    data: Any
    problem: ConsensusProblem

    @staticmethod
    def flat(loss_fn: Callable, data: Any, dim: int,
             cfg: Optional[ADMMConfig] = None, *,
             support: Optional[np.ndarray] = None,
             edge: Optional[Any] = None,
             rho_scale: Optional[Any] = None,
             l1_coef: Optional[float] = None,
             clip: Optional[float] = None,
             l2_coef: float = 0.0,
             selector=None, delay_model=None,
             backend: Optional[str] = None,
             mesh: Any = None,
             autotune: Optional[str] = None,
             device: DeviceLike = None) -> "ConsensusSession":
        """Flat-vector consensus over ``dim`` coordinates split into
        ``cfg.num_blocks`` blocks. Regularizer terms default to the
        config's (``cfg.l1_coef`` / ``cfg.clip``); kwargs override.
        ``backend`` (torch | cuda | auto) overrides ``cfg.backend``.
        ``mesh`` (a ``launch.mesh.Mesh`` or a preset name) overrides
        ``cfg.mesh``: every epoch then runs SPMD, workers sharded over
        the data axes and block servers over ``model``.
        ``device`` None means ``cuda``, and raises ``RuntimeError`` when
        there is no CUDA device."""
        cfg = cfg if cfg is not None else ADMMConfig()
        problem = make_problem(
            loss_fn, data, dim=dim, num_blocks=cfg.num_blocks,
            support=support, edge=edge,
            l1_coef=cfg.l1_coef if l1_coef is None else l1_coef,
            clip=cfg.clip if clip is None else clip,
            l2_coef=l2_coef, rho_scale=rho_scale,
            mesh=mesh if mesh is not None else cfg.mesh, device=device)
        spec = problem.spec(cfg, selector=selector, delay_model=delay_model,
                            backend=backend, autotune=autotune,
                            mesh=problem.mesh or "none")
        return ConsensusSession(spec=spec, cfg=cfg, data=problem.data,
                                problem=problem)

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------
    def init(self, z0: Any = None) -> ConsensusState:
        """Algorithm 1 lines 1-2 from the flat vector ``z0`` (default 0)."""
        return init_consensus_state(self.spec, z0)

    def step(self, state: ConsensusState, batch: Any = None
             ) -> Tuple[ConsensusState, Dict]:
        """One epoch of Algorithm 1. ``batch`` defaults to the session's
        fixed data."""
        data = batch if batch is not None else self.data
        return asybadmm_epoch(self.spec, state, data)

    def step_fn(self):
        """(state, batch) -> (state, info). The reference jits this; the
        port runs eagerly."""
        spec = self.spec
        return lambda s, b: asybadmm_epoch(spec, s, b)

    def run_ps(self, num_rounds: int, z0: Any = None, *,
               discipline: str = "lockfree",
               timing: Any = None,
               batches: Optional[Callable[[int], Any]] = None,
               compute: str = "real",
               seed: Optional[int] = None,
               record_z: bool = True,
               faults: Any = None,
               transport: Any = None,
               check_finite: bool = False,
               checkpoint_every: Optional[int] = None,
               checkpoint_dir: Optional[str] = None,
               resume_from: Optional[str] = None,
               telemetry: Any = None,
               metrics_every: Optional[int] = None):
        """Drive ``num_rounds`` rounds under the event-driven Parameter
        Server runtime (``repro_torch.ps``) instead of the vectorized
        epoch: per-block ``lockfree`` servers (or the ``locked``
        full-vector baseline), workers running the real space ops on the
        session's device (on the card: B1 per worker compute, B2 per
        block commit), bounded staleness enforced by stalling
        (Assumption 3's T comes from the session's delay model), and
        every pull recorded into a :class:`~repro_torch.ps.trace.DelayTrace`.

        ``timing`` is a :class:`~repro_torch.ps.timing.CostProfile`
        (service times; defaults to unit worker cost). ``compute="timing"``
        skips the numerics for pure coordination studies;
        ``record_z=False`` keeps only the live staleness window of
        committed versions (``z_final`` still returned, ``z_versions``
        not). Returns a :class:`~repro_torch.ps.runtime.PSRunResult`
        (``z_final`` / ``z_versions`` flat vectors on the session's
        device) — replay its trace through the epoch with
        ``delay_model=result.to_delay_model()``.

        ``faults`` is a :class:`~repro_torch.ps.chaos.FaultPlan` (or a
        path to its JSON) injecting worker crash/rejoin, joins/leaves,
        slowdowns, server commit spikes and link loss; ``transport`` a
        :class:`~repro_torch.ps.timing.Transport` (drop/dup/reorder with
        ack/retry), a shortcut for ``timing.net``;
        ``check_finite=True`` halts the run with a ``FloatingPointError``
        the moment a committed z goes NaN/Inf. ``telemetry=`` (True, a
        ``.jsonl`` path, ``"stdout"``, a callable, or a
        :class:`~repro_torch.obs.Telemetry`) turns the deterministic
        telemetry layer on; it never perturbs the run (z bitwise equal,
        same makespan). ``metrics_every=k`` streams every k-th round.

        ``checkpoint_every``, ``checkpoint_dir``, ``resume_from`` and
        ``server_crash`` fault events keep the reference's signature and
        raise ``NotImplementedError``: the durability layer is ROADMAP
        Queue A item 1."""
        from .ps import PSRuntime
        from .ps.chaos import FaultPlan
        from .ps.timing import CostProfile
        if isinstance(faults, (str, bytes)) or hasattr(faults, "__fspath__"):
            faults = FaultPlan.load(faults)
        if transport is not None:
            if timing is not None and timing.net is not None:
                raise ValueError(
                    "pass the Transport either as transport= or as "
                    "timing.net, not both")
            timing = dataclasses.replace(
                timing if timing is not None else CostProfile(),
                net=transport)
        rt = PSRuntime(self.spec, data=self.data, batches=batches,
                       discipline=discipline, timing=timing,
                       compute=compute, seed=seed, record_z=record_z,
                       faults=faults, check_finite=check_finite,
                       telemetry=telemetry, metrics_every=metrics_every)
        return rt.run(num_rounds, z0=z0, checkpoint_every=checkpoint_every,
                      checkpoint_dir=checkpoint_dir,
                      resume_from=resume_from)

    def run(self, num_epochs: int, z0: Any = None, *,
            batches: Optional[Callable[[int], Any]] = None,
            eval_every: int = 0,
            eval_fn: Optional[Callable] = None
            ) -> Tuple[ConsensusState, List[Dict]]:
        """Drive ``num_epochs`` epochs. ``batches(t)`` supplies the epoch-t
        per-worker batch (defaults to the fixed data). Eval records carry
        ``loss`` and ``objective`` plus ``eval_fn(session, state)``
        extras."""
        state = self.init(z0)
        step = self.step_fn()
        hist: List[Dict] = []
        for t in range(num_epochs):
            data = batches(t) if batches is not None else self.data
            state, info = step(state, data)
            if eval_every and (t + 1) % eval_every == 0:
                rec = {"epoch": t + 1, "loss": float(info["loss"]),
                       "objective": self.objective(state)}
                if eval_fn is not None:
                    rec.update(eval_fn(self, state))
                hist.append(rec)
        return state, hist

    # ------------------------------------------------------------------
    # inspection
    # ------------------------------------------------------------------
    def z(self, state: ConsensusState):
        """Newest consensus value as a flat vector (on a sharded state,
        the model shards gathered)."""
        return self.spec.space.to_user(full_z_blocks(self.spec, state))

    def objective(self, state: ConsensusState) -> float:
        return float(self.problem.objective(self.z(state)))

    def consensus_residual(self, state: ConsensusState) -> float:
        """Cross-worker w-cache dispersion (0 at consensus)."""
        return float(consensus_residual(self.spec, state))

    def stationarity(self, state: ConsensusState) -> Dict:
        # per-worker rho_i, so heterogeneous rho_scale runs are scored
        # against the Lagrangian they actually optimized
        return stationarity(self.problem, state, self.spec.rho_vec,
                            self.spec)

    def kkt_violations(self, state: ConsensusState) -> Dict:
        return kkt_violations(self.problem, state, self.spec.rho_vec,
                              self.spec)


def solve(loss_fn: Callable, data: Any, dim: int, num_epochs: int = 500,
          cfg: Optional[ADMMConfig] = None, *, eval_every: int = 0,
          z0: Any = None, **flat_kwargs):
    """One-call flat solve: build a session, run it, return (z, history).

    ``flat_kwargs`` forward to :meth:`ConsensusSession.flat`
    (support/edge/rho_scale/l1_coef/clip/device/...).
    """
    sess = ConsensusSession.flat(loss_fn, data, dim, cfg, **flat_kwargs)
    state, hist = sess.run(num_epochs, z0=z0,
                           eval_every=eval_every or num_epochs)
    return sess.z(state), hist
