"""Stationarity metric P (eqs. 14-15) and the KKT violations.

P(X,Y,z) = ||z - z_hat||^2 + sum_E ||grad_{x_ij} L||^2 + sum_E ||x_ij - z_j||^2
z_hat    = prox_h( z - grad_z(L - h) )

P -> 0 certifies a KKT/stationary point of problem (1) (Theorem 1.3).
"""
from __future__ import annotations

import torch

from .consensus import ConsensusProblem
from .space import ConsensusState


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


def stationarity(problem: ConsensusProblem, state: ConsensusState,
                 rho) -> dict:
    blocks = problem.blocks
    rho = _rho_b(rho)
    edge_m = problem.edge[..., None]                       # (N, M, 1)
    zb = state.z_hist[0]                                   # (M, dblk)
    gb = _grads_at_x(problem, state)                       # (N, M, dblk)

    # grad_{x_ij} L = grad_j f_i(x_i) + y_ij + rho (x_ij - z_j)
    gradL_x = torch.where(edge_m, gb + state.y + rho * (state.x - zb[None]),
                          0.0)

    # grad_z (L - h) = sum_{i in N(j)} [ -y_ij - rho (x_ij - z_j) ]
    gradL_z = torch.sum(torch.where(edge_m,
                                    -state.y - rho * (state.x - zb[None]),
                                    0.0), dim=0)           # (M, dblk)
    z_vec = blocks.from_blocks(zb)
    v = blocks.from_blocks(zb - gradL_z)
    z_hat = problem.reg.prox(v, 1.0)                       # eq. 15, mu = 1

    cons = torch.where(edge_m, state.x - zb[None], 0.0)
    P = (torch.sum(torch.square(z_vec - z_hat))
         + torch.sum(torch.square(gradL_x))
         + torch.sum(torch.square(cons)))
    return {
        "P": P,
        "primal_residual": torch.sqrt(torch.sum(torch.square(cons))),
        "grad_norm": torch.sqrt(torch.sum(torch.square(gradL_x))),
        "prox_residual": torch.sqrt(torch.sum(torch.square(z_vec - z_hat))),
    }


def kkt_violations(problem: ConsensusProblem, state: ConsensusState,
                   rho) -> dict:
    """Theorem 1.2 KKT conditions at the limit point:
    (20a) grad_j f_i(x_i*) + y_ij* = 0
    (20c) x_ij* = z_j*
    (20b) sum_i y_ij* in subdiff h_j(z_j*)  — checked via the prox
          fixed-point residual ||z - prox_h(z + sum_i y_i)||."""
    blocks = problem.blocks
    edge_m = problem.edge[..., None]
    zb = state.z_hist[0]
    gb = _grads_at_x(problem, state)

    kkt_a = torch.max(torch.abs(torch.where(edge_m, gb + state.y, 0.0)))
    kkt_c = torch.max(torch.abs(torch.where(edge_m, state.x - zb[None], 0.0)))
    y_sum = torch.sum(torch.where(edge_m, state.y, 0.0), dim=0)
    v = blocks.from_blocks(zb + y_sum)
    kkt_b = torch.max(torch.abs(blocks.from_blocks(zb)
                                - problem.reg.prox(v, 1.0)))
    return {"kkt_grad": kkt_a, "kkt_consensus": kkt_c, "kkt_subgrad": kkt_b}
