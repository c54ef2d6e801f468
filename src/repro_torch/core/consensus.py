"""Flat-mode AsyBADMM driver — the paper's Algorithm 1, end to end.

A thin adapter: the problem description (``ConsensusProblem``) binds
data + regularizer + edge set, and every step routes through the
generic ``core.space.asybadmm_epoch`` over a ``FlatSpace``. Baselines
fall out as config points:

* ``max_delay=0, block_fraction=1``  -> block-wise *synchronous* ADMM (§3.1)
* ``num_blocks=1, max_delay>0``      -> full-vector asynchronous ADMM
* ``num_blocks=M, max_delay>0``      -> AsyBADMM (the paper's algorithm)

With a mesh (``make_problem(mesh=)`` or ``cfg.mesh``), every epoch runs
SPMD over the mesh's ranks (core/sharded.py). A problem built with a mesh
keeps only the data rows its rank differentiates.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..configs.base import ADMMConfig
from ..device import DeviceLike, resolve_device
from ..launch.mesh import resolve_mesh
from .blocks import FlatBlocks, edge_set_from_support, make_flat_blocks
from .prox import Regularizer, make_prox
from .sharded import full_z_blocks, psum_rank_data, tile_for, \
    validate_space_mesh
from .space import (ConsensusSpec, ConsensusState, FlatSpace, asybadmm_epoch,
                    init_consensus_state, make_spec)

# The reference's name for the flat path's state: the generic one.
AsyBADMMState = ConsensusState


@dataclasses.dataclass(frozen=True)
class ConsensusProblem:
    """General form consensus problem (eq. 4) over a flat variable.

    loss_fn(z_vec, worker_data) -> scalar f_i; must be smooth.
    data: pytree of tensors whose leaves have leading axis N — or, with
          ``mesh`` set, this rank's rows of them (``sharded.rank_data``).
    edge: (N, M) bool — the paper's edge set E.
    """
    loss_fn: Callable
    data: Any
    dim: int
    num_workers: int
    blocks: FlatBlocks
    edge: torch.Tensor
    reg: Regularizer
    device: torch.device
    # per-worker penalty multipliers: effective rho_i = cfg.rho * rho_scale[i]
    rho_scale: Optional[torch.Tensor] = None
    # the launch.mesh.Mesh the data was cut for, or None (all N rows)
    mesh: Any = None

    def rho_vec(self, rho: float) -> torch.Tensor:
        """(N,) per-worker penalties rho_i = rho * rho_scale[i]."""
        if self.rho_scale is None:
            return torch.full((self.num_workers,), float(rho),
                              dtype=torch.float32, device=self.device)
        return rho * self.rho_scale

    def space(self) -> FlatSpace:
        return FlatSpace(blocks=self.blocks, num_workers=self.num_workers)

    def spec(self, cfg: ADMMConfig, **overrides) -> ConsensusSpec:
        """The generic step spec for this problem under ``cfg`` (on the
        problem's mesh, when it has one)."""
        kw = dict(edge=self.edge, rho_scale=self.rho_scale, reg=self.reg,
                  track_x=True, device=self.device)
        if self.mesh is not None:
            kw["mesh"] = self.mesh
        kw.update(overrides)
        return make_spec(self.space(), cfg, self.loss_fn, **kw)

    def worker_loss(self, z_vec, i: int):
        """f_i(z): worker i's loss, i a row of ``data`` (all N workers'
        rows without a mesh)."""
        return self.loss_fn(z_vec, pytree.tree_map(lambda a: a[i],
                                                   self.data))

    def objective(self, z_vec):
        """Global objective (1): sum_i f_i(z) + h(z); on a mesh, this
        rank's losses completed over the ranks holding the other rows."""
        losses = torch.sum(torch.func.vmap(self.loss_fn, in_dims=(None, 0))(
            z_vec, self.data))
        if self.mesh is not None:
            losses = psum_rank_data(self.mesh, self.num_workers,
                                    self.blocks.num_blocks, losses)
        return losses + self.reg.value(z_vec)


def make_problem(loss_fn, data, dim: int, num_blocks: int,
                 support: Optional[np.ndarray] = None,
                 l1_coef: float = 0.0, clip: Optional[float] = None,
                 l2_coef: float = 0.0,
                 rho_scale: Optional[Any] = None,
                 edge: Optional[Any] = None,
                 mesh: Any = None,
                 device: DeviceLike = None) -> ConsensusProblem:
    """``data`` leaves (numpy arrays or tensors, all N workers' rows) are
    moved to ``device`` (None -> ``cuda``); floating leaves become
    float32, the epoch's type, as JAX's default 32-bit mode makes them in
    the reference. With ``mesh`` (a ``launch.mesh.Mesh`` or a preset
    name) only the rows this rank differentiates reach the device."""
    dev = resolve_device(device)
    mesh = resolve_mesh(mesh)
    n = pytree.tree_leaves(data)[0].shape[0]
    blocks = make_flat_blocks(dim, num_blocks)
    tile = None
    if mesh is not None:
        validate_space_mesh(FlatSpace(blocks=blocks, num_workers=n,
                                      mesh=mesh))
        tile = tile_for(mesh, n, num_blocks)

    def to_device(a):
        if tile is None:
            a = torch.as_tensor(a, device=dev)
        else:            # a copy of this rank's rows, not a view of all N
            a = tile.grad_rows(torch.as_tensor(a))
            a = a.to(dev, copy=a.shape[0] < n)
        return a.to(torch.float32) if a.is_floating_point() else a
    data = pytree.tree_map(to_device, data)
    if edge is None and support is not None:
        edge = edge_set_from_support(np.asarray(support), blocks)
    if edge is None:
        edge = torch.ones((n, num_blocks), dtype=torch.bool, device=dev)
    else:
        edge = torch.as_tensor(edge, device=dev).to(torch.bool)
    return ConsensusProblem(
        loss_fn=loss_fn, data=data, dim=dim, num_workers=n, blocks=blocks,
        edge=edge, reg=make_prox(l1_coef, clip, l2_coef), device=dev,
        rho_scale=None if rho_scale is None else torch.as_tensor(
            rho_scale, dtype=torch.float32, device=dev), mesh=mesh)


def init_state(problem: ConsensusProblem, cfg: ADMMConfig,
               z0=None) -> ConsensusState:
    return init_consensus_state(problem.spec(cfg), z0)


def asybadmm_step(problem: ConsensusProblem, cfg: ADMMConfig,
                  state: AsyBADMMState) -> AsyBADMMState:
    """One epoch of Algorithm 1 across all workers + servers."""
    new, _ = asybadmm_epoch(problem.spec(cfg), state, problem.data)
    return new


def make_step_fn(problem: ConsensusProblem, cfg: ADMMConfig):
    spec = problem.spec(cfg)
    data = problem.data

    def step(state):
        new, _ = asybadmm_epoch(spec, state, data)
        return new
    return step


def run(problem: ConsensusProblem, cfg: ADMMConfig, num_epochs: int,
        z0=None, eval_every: int = 0, eval_fn: Optional[Callable] = None):
    """Convenience driver: returns (state, history list of eval results)."""
    spec = problem.spec(cfg)
    state = init_consensus_state(spec, z0)
    hist = []
    for t in range(num_epochs):
        state, _ = asybadmm_epoch(spec, state, problem.data)
        if eval_every and (t + 1) % eval_every == 0:
            z = problem.blocks.from_blocks(full_z_blocks(spec, state))
            res = {"epoch": t + 1, "objective": float(problem.objective(z))}
            if eval_fn is not None:
                res.update(eval_fn(problem, state))
            hist.append(res)
    return state, hist
