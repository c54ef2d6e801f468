"""Stationarity metric P (eqs. 14-15) and the KKT violations.

P(X,Y,z) = ||z - z_hat||^2 + sum_E ||grad_{x_ij} L||^2 + sum_E ||x_ij - z_j||^2
z_hat    = prox_h( z - grad_z(L - h) )

P -> 0 certifies a KKT/stationary point of problem (1) (Theorem 1.3).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .consensus import AsyBADMMState, ConsensusProblem
from .space import ConsensusSpec, ConsensusState


def _rho_b(rho):
    """Accept a scalar rho or a per-worker (N,) rho_i vector and return
    it broadcastable against (N, M, dblk) worker bundles."""
    rho = torch.as_tensor(rho)
    return rho[:, None, None] if rho.ndim == 1 else rho


def _grads_at_x(problem: ConsensusProblem, state: ConsensusState):
    """grad f_i at each worker's own x_i, packed (N, M, dblk)."""
    blocks = problem.blocks
    g = torch.func.vmap(torch.func.grad(problem.loss_fn))(
        blocks.from_blocks(state.x), problem.data)
    return blocks.to_blocks(g)


def _same(x):
    return x


class _View(NamedTuple):
    """The worker tiles a measure reads, and how its partial results
    complete. On one device the tiles are the whole (N, M, dblk) bundles
    and nothing is left to complete; on a mesh they are this rank's
    (Nl, Ml, dblk) tiles and the completions are collectives."""
    edge: torch.Tensor               # (Nl, Ml) bool
    rho: torch.Tensor                # broadcastable to (Nl, Ml, dblk)
    y: torch.Tensor
    x: torch.Tensor
    z: torch.Tensor                  # (Ml, dblk): the newest z, this tile
    z_full: torch.Tensor             # (M, dblk): the newest z
    grads: Callable                  # () -> grad f_i(x_i), (Nl, Ml, dblk)
    sum_workers: Callable            # (Nl, Ml, dblk) -> (M, dblk) over all
    total: Callable                  # partial sum -> the sum over all tiles
    peak: Callable                   # partial max -> the max over all tiles


def _view(problem: ConsensusProblem, state: ConsensusState, rho,
          spec=None) -> _View:
    if spec is None or spec.space.mesh is None:
        zb = state.z_hist[0]
        return _View(edge=problem.edge, rho=_rho_b(rho), y=state.y,
                     x=state.x, z=zb, z_full=zb,
                     grads=lambda: _grads_at_x(problem, state),
                     sum_workers=lambda a: torch.sum(a, dim=0),
                     total=_same, peak=_same)
    from .sharded import (MeshCollectives, local_grads, local_space,
                          local_tile, rank_data)
    tile, coll = local_tile(spec), MeshCollectives(spec.space.mesh)
    rho = _rho_b(rho)
    if rho.ndim == 3:
        rho = tile.rows(rho)
    data = rank_data(tile, spec.space.num_workers, problem.data)
    return _View(
        edge=tile.cols(tile.rows(problem.edge)), rho=rho, y=state.y,
        x=state.x, z=state.z_hist[0],
        z_full=coll.full_blocks(state.z_hist[0]),
        grads=lambda: local_grads(local_space(spec, tile.Nl), coll, tile,
                                  problem.loss_fn, state.x, data)[1],
        sum_workers=lambda a: coll.full_blocks(
            coll.psum_data(torch.sum(a, dim=0))),
        total=coll.reduce_all,
        peak=lambda a: coll.reduce_all(a, torch.distributed.ReduceOp.MAX))


def stationarity(problem: ConsensusProblem, state: ConsensusState,
                 rho, spec: ConsensusSpec = None) -> dict:
    """P and its parts. With ``spec`` on a mesh, ``state`` is this rank's
    tiles: the same numbers come out on every rank, and no worker bundle
    is gathered."""
    v = _view(problem, state, rho, spec)
    blocks = problem.blocks
    edge_m = v.edge[..., None]                             # (N, M, 1)
    zb = v.z                                               # (M, dblk)
    gb = v.grads()                                         # (N, M, dblk)

    # grad_{x_ij} L = grad_j f_i(x_i) + y_ij + rho (x_ij - z_j)
    gradL_x = torch.where(edge_m, gb + v.y + v.rho * (v.x - zb[None]), 0.0)

    # grad_z (L - h) = sum_{i in N(j)} [ -y_ij - rho (x_ij - z_j) ]
    gradL_z = v.sum_workers(torch.where(
        edge_m, -v.y - v.rho * (v.x - zb[None]), 0.0))     # (M, dblk)
    z_vec = blocks.from_blocks(v.z_full)
    z_hat = problem.reg.prox(blocks.from_blocks(v.z_full - gradL_z),
                             1.0)                          # eq. 15, mu = 1

    cons = torch.where(edge_m, v.x - zb[None], 0.0)
    gx2 = v.total(torch.sum(torch.square(gradL_x)))
    cons2 = v.total(torch.sum(torch.square(cons)))
    P = torch.sum(torch.square(z_vec - z_hat)) + gx2 + cons2
    return {
        "P": P,
        "primal_residual": torch.sqrt(cons2),
        "grad_norm": torch.sqrt(gx2),
        "prox_residual": torch.sqrt(torch.sum(torch.square(z_vec - z_hat))),
    }


def block_residuals(z, y, x, edge, rho, reg=None, grads=None) -> dict:
    """Per-block decomposition of P over the packed representation —
    the telemetry quantities the PS runtime streams per round.

    Inputs are the packed tensors (block j = row j): ``z`` (M, dblk),
    ``y``/``x`` (N, M, dblk), ``edge`` (N, M) bool, ``rho`` scalar or
    per-worker (N,). ``reg`` enables the prox-residual term (the
    ``make_prox`` family is elementwise, so it applies to the packed
    table directly; zero pads are fixed points of l1/box/l2, so pads
    contribute nothing); ``grads`` (N, M, dblk) — grad f_i at x_i in
    packed form — enables the gradient term. Returns per-block (M,)
    tensors ``primal``/``prox``/``grad`` (residual norms; prox/grad are
    None when their input is absent) and ``P`` (the per-block sum of
    squares of whatever terms were computable; summed over blocks it is
    ``stationarity``'s P up to fp reassociation when all terms are
    present)."""
    rho = _rho_b(rho)
    edge_m = edge[..., None]                               # (N, M, 1)
    cons = torch.where(edge_m, x - z[None], 0.0)           # (N, M, dblk)
    primal_sq = torch.sum(torch.square(cons), dim=(0, 2))  # (M,)
    P_blocks = primal_sq
    prox_b = None
    if reg is not None:
        gradL_z = torch.sum(torch.where(edge_m, -y - rho * (x - z[None]),
                                        0.0), dim=0)       # (M, dblk)
        z_hat = reg.prox(z - gradL_z, 1.0)                 # eq. 15, mu = 1
        prox_sq = torch.sum(torch.square(z - z_hat), dim=1)  # (M,)
        prox_b = torch.sqrt(prox_sq)
        P_blocks = P_blocks + prox_sq
    grad_b = None
    if grads is not None:
        gradL_x = torch.where(edge_m, grads + y + rho * (x - z[None]), 0.0)
        grad_sq = torch.sum(torch.square(gradL_x), dim=(0, 2))
        grad_b = torch.sqrt(grad_sq)
        P_blocks = P_blocks + grad_sq
    return {"primal": torch.sqrt(primal_sq), "prox": prox_b,
            "grad": grad_b, "P": P_blocks}


def stationarity_blocks(problem: ConsensusProblem, state: AsyBADMMState,
                        rho) -> dict:
    """Per-block view of :func:`stationarity` on one device: the same P
    (eqs. 14-15) decomposed over blocks by :func:`block_residuals`, with
    the gradient term evaluated as ``stationarity`` does. Each per-block
    tensor sums (in squares) to the corresponding total up to fp
    reassociation."""
    return block_residuals(state.z_hist[0], state.y, state.x, problem.edge,
                           rho, reg=problem.reg,
                           grads=_grads_at_x(problem, state))


def kkt_violations(problem: ConsensusProblem, state: ConsensusState,
                   rho, spec: ConsensusSpec = None) -> dict:
    """Theorem 1.2 KKT conditions at the limit point:
    (20a) grad_j f_i(x_i*) + y_ij* = 0
    (20c) x_ij* = z_j*
    (20b) sum_i y_ij* in subdiff h_j(z_j*)  — checked via the prox
          fixed-point residual ||z - prox_h(z + sum_i y_i)||.
    ``spec`` as for :func:`stationarity`."""
    v = _view(problem, state, rho, spec)
    blocks = problem.blocks
    edge_m = v.edge[..., None]
    gb = v.grads()

    kkt_a = v.peak(torch.max(torch.abs(torch.where(edge_m, gb + v.y, 0.0))))
    kkt_c = v.peak(torch.max(torch.abs(torch.where(edge_m,
                                                   v.x - v.z[None], 0.0))))
    y_sum = v.sum_workers(torch.where(edge_m, v.y, 0.0))
    w = blocks.from_blocks(v.z_full + y_sum)
    kkt_b = torch.max(torch.abs(blocks.from_blocks(v.z_full)
                                - problem.reg.prox(w, 1.0)))
    return {"kkt_grad": kkt_a, "kkt_consensus": kkt_c, "kkt_subgrad": kkt_b}
