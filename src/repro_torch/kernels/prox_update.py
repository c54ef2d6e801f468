"""AsyBADMM server update, eq. (13): the l1 + box prox of the
gamma-stabilised weighted average, in two kernels.

Ports of ``repro/kernels/prox_update.py``:

* ``server_prox_fused_2d`` — the edge-masked reduction of the stale-w
  cache over workers fused with the prox (the single-device epoch):
  ``server_prox_update_torch`` / ``server_prox_update_cuda``;
* ``prox_consensus_2d`` — the prox from a w_sum that is already reduced
  (the SPMD epoch, whose worker sum is a partial sum plus an all-reduce
  over the data ranks): ``prox_consensus_torch`` / ``prox_consensus_cuda``.

Each ``*_torch`` is the plain torch version, written as its kernel
computes (the worker sum taken in order n = 0..N-1, then the prox tail):
the CPU path, and the yardstick the CUDA kernel is held to. Each
``*_cuda`` launches its kernel from ``csrc/prox_update.cu`` on the
tensors' device and current stream; ``launches`` counts the launches of
each, by op name.

``gamma``, ``l1`` and ``clip`` are floats; ``l1 > 0`` and ``clip > 0``
gate their steps (``clip = 0`` means "no box", so a degenerate box
{0} must stay off these ops — ``core.prox.Regularizer.fusable``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .admm_update import _check_bundle

launches = {"server_prox_update": 0, "prox_consensus": 0}
_fns = {}


def prox_tail(v, mu, l1: float, clip: float):
    if l1 > 0.0:
        thr = l1 / mu
        v = torch.sign(v) * torch.clamp_min(torch.abs(v) - thr, 0.0)
    if clip > 0.0:
        v = torch.clamp(v, -clip, clip)
    return v


def server_prox_update_torch(z_cur, w_cache, edge, rho_sum, gamma: float,
                             l1: float = 0.0, clip: float = 0.0):
    """z_cur: (M, d); w_cache: (N, M, d); edge: (N, M) bool;
    rho_sum: (M,). Returns z_new (M, d)."""
    acc = torch.zeros_like(z_cur)
    for n in range(w_cache.shape[0]):
        acc = acc + torch.where(edge[n][:, None], w_cache[n], 0.0)
    mu = gamma + rho_sum[:, None]
    return prox_tail((gamma * z_cur + acc) / mu, mu, l1, clip)


def prox_consensus_torch(z_tilde, w_sum, rho_sum, gamma: float,
                         l1: float = 0.0, clip: float = 0.0):
    """z_tilde, w_sum: (M, d); rho_sum: (M,). Returns z_new (M, d)."""
    mu = gamma + rho_sum[:, None]
    return prox_tail((gamma * z_tilde + w_sum) / mu, mu, l1, clip)


def _function(name: str, n_pointers: int, n_sizes: int):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("prox_update"), name)
        fn.argtypes = [ctypes.c_void_p] * n_pointers + [
            ctypes.c_int64] * n_sizes + [ctypes.c_float] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_rho_sum(rho_sum, M: int, dev):
    if rho_sum.device != dev or rho_sum.dtype != torch.float32 \
            or tuple(rho_sum.shape) != (M,):
        raise ValueError(f"rho_sum: expected ({M},) float32 on {dev}")
    return rho_sum.contiguous()


def _launch(name: str, fn, args, dev):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def server_prox_update_cuda(z_cur, w_cache, edge, rho_sum, gamma: float,
                            l1: float = 0.0, clip: float = 0.0):
    """The fused CUDA kernel. Same arguments and result as the plain
    version; every tensor on one CUDA device, d % 4 == 0 (the ops layer
    demands d % 128 == 0)."""
    dev = z_cur.device
    if dev.type != "cuda":
        raise ValueError(f"server_prox_update_cuda needs CUDA tensors, "
                         f"got {dev}")
    N, M, d = w_cache.shape
    if d % 4:
        raise ValueError(f"row width d={d} is not a multiple of 4")
    _check_bundle("z_cur", z_cur, (M, d), dev)
    _check_bundle("w_cache", w_cache, (N, M, d), dev)
    if edge.device != dev or edge.dtype != torch.bool \
            or tuple(edge.shape) != (N, M):
        raise ValueError(f"edge: expected ({N}, {M}) bool on {dev}")
    rs = _check_rho_sum(rho_sum, M, dev)
    edge_u8 = edge.contiguous().view(torch.uint8)
    z_out = torch.empty_like(z_cur)
    _launch("server_prox_update",
            _function("server_prox_update", 5, 3),
            (z_cur.data_ptr(), w_cache.data_ptr(), edge_u8.data_ptr(),
             rs.data_ptr(), z_out.data_ptr(), N, M, d, float(gamma),
             float(l1), float(clip)), dev)
    return z_out


def prox_consensus_cuda(z_tilde, w_sum, rho_sum, gamma: float,
                        l1: float = 0.0, clip: float = 0.0):
    """The prox-only CUDA kernel. Same arguments and result as the plain
    version; every tensor on one CUDA device, d % 4 == 0 (the ops layer
    demands d % 128 == 0)."""
    dev = z_tilde.device
    if dev.type != "cuda":
        raise ValueError(f"prox_consensus_cuda needs CUDA tensors, got {dev}")
    M, d = z_tilde.shape
    if d % 4:
        raise ValueError(f"row width d={d} is not a multiple of 4")
    _check_bundle("z_tilde", z_tilde, (M, d), dev)
    _check_bundle("w_sum", w_sum, (M, d), dev)
    rs = _check_rho_sum(rho_sum, M, dev)
    z_out = torch.empty_like(z_tilde)
    _launch("prox_consensus", _function("prox_consensus", 4, 2),
            (z_tilde.data_ptr(), w_sum.data_ptr(), rs.data_ptr(),
             z_out.data_ptr(), M, d, float(gamma), float(l1), float(clip)),
            dev)
    return z_out
