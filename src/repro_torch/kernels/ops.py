"""The epoch's kernel ops, dispatched on the tensors' device: the fused
worker update, the fused server update (single-device epoch) and the
server prox from a reduced w_sum (SPMD epoch).

On CUDA tensors each op launches its hand-written kernel (or raises: it
never falls back to the plain version). On CPU tensors it runs the
kernel's plain torch version, because there is no kernel to launch.

Lane alignment is a property of the layout (``core.blocks`` rounds every
block row up to 128), so every op refuses rows whose width is not a
multiple of 128, with the reference's ``ValueError`` contract.
"""
from __future__ import annotations

from typing import Dict

from . import admm_update as _admm
from . import prox_update as _prox

LANE = 128


def _require_lane_aligned(d: int, op: str) -> None:
    if d % LANE != 0:
        raise ValueError(
            f"{op}: block row width d={d} is not a multiple of {LANE}; "
            f"lane alignment is a property of the layout — build blocks "
            f"via core.blocks.make_flat_blocks (which rounds block_dim up "
            f"to {LANE}) rather than padding per call.")


def admm_worker_select_update(g, y, z_tilde, w_old, sel, rho_vec,
                              x_old=None):
    """Worker side of one epoch of Algorithm 1, fused: eqs. (11)+(12)+(9)
    plus the sel-masked merge of y / w_cache [/ x] in one pass.

    g, y, z_tilde, w_old [, x_old] : (N, M, dblk) with dblk lane-aligned;
    sel     : (N, M) bool — the selected (worker, block) pairs;
    rho_vec : (N,) per-worker penalties.

    Returns (y', w'[, x'])."""
    _require_lane_aligned(g.shape[-1], "admm_worker_select_update")
    if g.is_cuda:
        return _admm.admm_worker_select_update_cuda(
            g, y, z_tilde, w_old, sel, rho_vec, x_old)
    return _admm.admm_worker_select_update_torch(
        g, y, z_tilde, w_old, sel, rho_vec, x_old)


def server_prox_update(z_cur, w_cache, edge, rho_sum, gamma: float,
                       l1: float = 0.0, clip: float = 0.0):
    """Server side of one epoch of Algorithm 1, fused: the edge-masked
    reduction of the stale-w cache over workers AND the prox step (13).

    z_cur: (M, d) lane-aligned; w_cache: (N, M, d); edge: (N, M) bool;
    rho_sum: (M,) per-block penalty sums. Returns z_new (M, d)."""
    _require_lane_aligned(z_cur.shape[-1], "server_prox_update")
    if z_cur.is_cuda:
        return _prox.server_prox_update_cuda(
            z_cur, w_cache, edge, rho_sum, gamma, l1, clip)
    return _prox.server_prox_update_torch(
        z_cur, w_cache, edge, rho_sum, gamma, l1, clip)


def prox_consensus(z_tilde, w_sum, rho_sum, gamma: float, l1: float = 0.0,
                   clip: float = 0.0):
    """The prox step (13) from an already-reduced w_sum — the server step
    of the SPMD epoch, where the worker sum is a partial sum over the
    local workers plus an all-reduce over the data ranks.

    z_tilde, w_sum: (M, d) lane-aligned; rho_sum: (M,) or (M, 1)
    per-block penalty sums. Returns z_new (M, d)."""
    M, d = z_tilde.shape
    _require_lane_aligned(d, "prox_consensus")
    rho_sum = rho_sum.reshape(M)
    if z_tilde.is_cuda:
        return _prox.prox_consensus_cuda(z_tilde, w_sum, rho_sum, gamma, l1,
                                         clip)
    return _prox.prox_consensus_torch(z_tilde, w_sum, rho_sum, gamma, l1,
                                      clip)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by op."""
    return {"admm_worker_select_update": _admm.launches, **_prox.launches}


def reset_launch_counts() -> None:
    _admm.launches = 0
    for name in _prox.launches:
        _prox.launches[name] = 0
