"""The logistic-regression gradient's two kernels (eq. 22, smooth part):

    g = X^T ( -y * sigmoid(-y * (X @ w)) ) / m.

Ports of ``repro/kernels/logreg_grad.py``:

* ``matmul`` — C = A B, or A^T B without building A^T, fp32 accumulator:
  ``matmul_torch`` / ``matmul_cuda``;
* ``margin`` — v = -y * sigmoid(-y * s) elementwise: ``margin_torch`` /
  ``margin_cuda``.

Each ``*_torch`` is the plain torch version: the CPU path, and the
yardstick its CUDA kernel is held to. ``matmul_torch`` is one
``torch.matmul``, which is also the library call the kernel is timed
against; the kernel sums in another order, so both are held against a
float64 product (the kernel's error at most a small multiple of the
plain version's) rather than the kernel against the plain version's
bits. ``margin_torch`` computes as its
kernel does (``torch.sigmoid`` is 1 / (1 + exp(-t)) on the card). Each
``*_cuda`` launches its kernel from ``csrc/logreg_grad.cu`` on the
tensors' device and current stream; ``launches`` counts the launches of
each, by op name.

Both kernels take float32 only; any other dtype raises ``TypeError``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = {"matmul": 0, "margin": 0}
_fns = {}

_ARGTYPES = {
    "logreg_matmul": [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "logreg_margin": [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
}


def require_f32(op: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{op}: {name} is {t.dtype}; the kernel takes "
                            f"float32 only")


def matmul_torch(a, b, transpose_a: bool = False):
    """a: (M, K), or (K, M) with ``transpose_a``; b: (K, N). Returns
    (M, N)."""
    return torch.matmul(a.T if transpose_a else a, b)


def margin_torch(s, y):
    """s, y: one shape. Returns v = -y * sigmoid(-y * s)."""
    return -y * torch.sigmoid(-y * s)


def _function(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("logreg_grad"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(op: str, dev, **tensors) -> None:
    require_f32(op, **tensors)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{op}: {name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous (row-major); "
                             f"pass transpose_a rather than a transposed "
                             f"view")


def matmul_cuda(a, b, transpose_a: bool = False):
    """The CUDA kernel. Same arguments and result as the plain version;
    a and b float32, contiguous, on one CUDA device."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"matmul_cuda needs CUDA tensors, got {dev}")
    _check("matmul_cuda", dev, a=a, b=b)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"matmul_cuda: expected 2-D operands, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    K, M = a.shape if transpose_a else a.shape[::-1]
    K2, N = b.shape
    if K != K2:
        raise ValueError(f"matmul_cuda: inner sizes differ: a "
                         f"{tuple(a.shape)} (transpose_a={transpose_a}), b "
                         f"{tuple(b.shape)}")
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    fn = _function("logreg_matmul")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                 int(bool(transpose_a)), dev.index, stream)
    if err == -2:
        raise ValueError(f"matmul_cuda: ({M}, {N}) needs more tiles than "
                         f"a grid holds")
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed: cudaError {err}")
    launches["matmul"] += 1
    return out


def margin_cuda(s, y):
    """The CUDA kernel. Same arguments and result as the plain version;
    s and y float32, contiguous, one shape, on one CUDA device."""
    dev = s.device
    if dev.type != "cuda":
        raise ValueError(f"margin_cuda needs CUDA tensors, got {dev}")
    _check("margin_cuda", dev, s=s, y=y)
    if tuple(s.shape) != tuple(y.shape):
        raise ValueError(f"margin_cuda: s {tuple(s.shape)} and y "
                         f"{tuple(y.shape)} differ in shape")
    out = torch.empty_like(s)
    if s.numel() == 0:
        return out
    fn = _function("logreg_margin")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(s.data_ptr(), y.data_ptr(), out.data_ptr(), s.numel(),
                 dev.index, stream)
    if err != 0:
        raise RuntimeError(f"margin kernel launch failed: cudaError {err}")
    launches["margin"] += 1
    return out
