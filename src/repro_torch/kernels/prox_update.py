"""Fused AsyBADMM server update — the edge-masked reduction of the stale-w
cache over workers plus the l1 + box prox of eq. (13).

Port of ``repro/kernels/prox_update.py::server_prox_fused_2d``. Two
implementations of one function:

* ``server_prox_update_torch`` — the plain torch version, written as the
  kernel computes: the worker sum taken in order n = 0..N-1, then the
  prox tail. The CPU path, and the yardstick the CUDA kernel is held to;
* ``server_prox_update_cuda`` — launches ``csrc/prox_update.cu`` on the
  tensors' device and current stream; the (M, d) w_sum never reaches
  device memory. ``launches`` counts its launches.

``gamma``, ``l1`` and ``clip`` are floats; ``l1 > 0`` and ``clip > 0``
gate their steps (``clip = 0`` means "no box", so a degenerate box
{0} must stay off this op — ``core.prox.Regularizer.fusable``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .admm_update import _check_bundle

launches = 0
_fn = None


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


def _function():
    global _fn
    if _fn is None:
        fn = _build.load("prox_update").server_prox_update
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [
            ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def server_prox_update_cuda(z_cur, w_cache, edge, rho_sum, gamma: float,
                            l1: float = 0.0, clip: float = 0.0):
    """The CUDA kernel. Same arguments and result as the plain version;
    every tensor on one CUDA device, d % 4 == 0 (the ops layer demands
    d % 128 == 0)."""
    global launches
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
    if rho_sum.device != dev or rho_sum.dtype != torch.float32 \
            or tuple(rho_sum.shape) != (M,):
        raise ValueError(f"rho_sum: expected ({M},) float32 on {dev}")
    edge_u8 = edge.contiguous().view(torch.uint8)
    rs = rho_sum.contiguous()
    z_out = torch.empty_like(z_cur)
    fn = _function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(z_cur.data_ptr(), w_cache.data_ptr(), edge_u8.data_ptr(),
                 rs.data_ptr(), z_out.data_ptr(), N, M, d, float(gamma),
                 float(l1), float(clip), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"server_prox_update kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return z_out
