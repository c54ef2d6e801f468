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
