"""The kernel ops, dispatched on the tensors' device: the epoch's fused
worker update, fused server update (single-device epoch) and server
prox from a reduced w_sum (SPMD epoch); and the package's other kernel
entry points, the unmasked worker update on a flat buffer, the matmul
and the logistic-regression gradient built on it, and the model
stack's flash attention.

On CUDA tensors each op launches its hand-written kernel (or raises: it
never falls back to the plain version). On CPU tensors it runs the
kernel's plain torch version, because there is no kernel to launch.

Lane alignment is a property of the layout (``core.blocks`` rounds every
block row up to 128), so every epoch op refuses rows whose width is not
a multiple of 128, and ``admm_worker_update`` buffers whose element
count is not a multiple of 8*128, with the reference's ``ValueError``
contract. ``matmul`` and ``logreg_grad`` take any shape (data matrices
are not laid out by the package) in float32, bfloat16 or float16, with
a float32 accumulator and the result in the input dtype.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import admm_update as _admm
from . import flash_attention as _fa
from . import logreg as _lg
from . import prox_update as _prox

LANE = 128
SUBLANE = 8


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


def _flat_aligned(v):
    """``v`` as a flat buffer; raises for element counts that are not
    (8 x 128)-aligned: alignment is the layout's job."""
    n = v.numel()
    if n % (SUBLANE * LANE) != 0:
        raise ValueError(
            f"buffer of {n} elements (shape {tuple(v.shape)}) is not "
            f"({SUBLANE}x{LANE})-vreg aligned; kernel ops require "
            f"lane-aligned buffers. Pack through a lane-aligned layout "
            f"(core.blocks.make_flat_blocks rounds block_dim up to {LANE}) "
            f"instead of passing raw leaves.")
    return v.reshape(n)


def admm_worker_update(g, y, z_tilde, rho):
    """Fused eqs. (11)+(12)+(9) on arbitrarily shaped buffers of one
    shape, f32 or bf16, whose element count is a multiple of 8*128.
    ``rho`` is a number or a one-element tensor. Returns (x, y', w) in
    the buffers' shape and dtype."""
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"admm_worker_update takes float32 or bfloat16, got "
                        f"{g.dtype}")
    flat = [_flat_aligned(t) for t in (g, y, z_tilde)]
    if g.is_cuda:
        outs = _admm.admm_worker_update_cuda(*flat, rho)
    else:
        outs = _admm.admm_worker_update_torch(*flat, rho)
    return tuple(o.reshape(g.shape) for o in outs)


def matmul(a, b, transpose_a: bool = False):
    """C = A B, or A^T B (``a`` stored (K, M)) without building A^T.
    2-D, any sizes; float32, bfloat16 or float16 (one dtype), summed in
    float32, C in the operands' dtype."""
    _lg.require_float("matmul", a=a, b=b)
    if a.is_cuda:
        return _lg.matmul_cuda(a, b, transpose_a)
    return _lg.matmul_torch(a, b, transpose_a)


def _margin(s, y):
    """v = -y * sigmoid(-y * s) elementwise, computed in float32, in the
    operands' dtype."""
    _lg.require_float("margin", s=s, y=y)
    if s.is_cuda:
        return _lg.margin_cuda(s, y)
    return _lg.margin_torch(s, y)


def logreg_grad(X, y, w):
    """Gradient of the mean logistic loss: X (m, d), y (m,) in {-1, +1},
    w (d,), all of one float dtype. Two ``matmul`` launches around one
    ``margin`` launch (X w, then X^T v with X^T never built), then / m."""
    m, d = X.shape
    s = matmul(X, w.reshape(d, 1))
    v = _margin(s, y.reshape(m, 1))
    g = matmul(X, v, transpose_a=True)
    return g.reshape(d) / m


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """softmax(q kᵀ * scale [causal mask]) v with an online softmax:
    q (BH, S, hd), k and v (BH, T, hd), one float dtype, GQA heads
    already expanded. Returns (BH, S, hd) in q's dtype. ``scale``
    defaults to 1/sqrt(hd). On CUDA tensors the kernel takes hd 128 or
    256 and any S, T."""
    _fa.check_operands("flash_attention", q, k, v)
    if q.is_cuda:
        return _fa.flash_attention_cuda(q, k, v, causal, scale)
    return _fa.flash_attention_torch(q, k, v, causal, scale)


_COUNTERS = (_admm.launches, _prox.launches, _lg.launches, _fa.launches)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by op."""
    return {name: n for counter in _COUNTERS for name, n in counter.items()}


def matmul_design_counts() -> Dict[str, int]:
    """``matmul``'s kernel calls since the last reset, by design
    (``tiled``, ``gemv``, ``gemv16``, ``wgmma``, ``tf32x3``)."""
    return dict(_lg.designs)


def reset_launch_counts() -> None:
    for counter in (*_COUNTERS, _lg.designs):
        for name in counter:
            counter[name] = 0
