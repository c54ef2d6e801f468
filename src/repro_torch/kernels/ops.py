"""The epoch's two fused ops, dispatched on the tensors' device.

On CUDA tensors each op launches its hand-written kernel (or raises: it
never falls back to the plain version). On CPU tensors it runs the
kernel's plain torch version, because there is no kernel to launch.

Lane alignment is a property of the layout (``core.blocks`` rounds every
block row up to 128), so both ops refuse rows whose width is not a
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


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by op."""
    return {"admm_worker_select_update": _admm.launches,
            "server_prox_update": _prox.launches}


def reset_launch_counts() -> None:
    _admm.launches = 0
    _prox.launches = 0
