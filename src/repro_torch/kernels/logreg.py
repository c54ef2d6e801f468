"""The logistic-regression gradient's two kernels (eq. 22, smooth part):

    g = X^T ( -y * sigmoid(-y * (X @ w)) ) / m.

Ports of ``repro/kernels/logreg_grad.py``:

* ``matmul`` — C = A B, or A^T B without building A^T, fp32 accumulator:
  ``matmul_torch`` / ``matmul_cuda``. The CUDA entry point picks one of
  five designs by shape, type and alignment (see the note at the top of
  ``csrc/logreg_grad.cu``): ``gemv`` and ``gemv16`` for N = 1 (16-byte
  loads in 16 bits), ``wgmma`` (bf16/f16) and ``tf32x3`` (float32) on the
  tensor cores for N > 1, and ``tiled`` where TMA's or cp.async's
  alignment fails;
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
each, by op name (one a call, though gemv16's X^T v runs two kernels,
its split sums and their fixed-order total, and tf32x3 a scan for Inf
and NaN before its products), and ``designs`` counts the matmul's calls
by design.

Both kernels take float32, bfloat16 or float16, one dtype for all
operands, as the reference's kernels take their input's dtype: they
widen to float32, sum and multiply there, and round each output to the
input dtype once. The plain versions widen and round the same way. Any
other dtype, or operands of two dtypes, raise ``TypeError``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = {"matmul": 0, "margin": 0}
# the matmul's designs, by their code in csrc/logreg_grad.cu
DESIGNS = ("tiled", "gemv", "gemv16", "wgmma", "tf32x3")
designs = {name: 0 for name in DESIGNS}
_fns = {}

_ARGTYPES = {
    "logreg_matmul_plan": [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 3 + [
        ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int64)],
    "logreg_matmul": [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p],
    "logreg_margin": [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
# the element types the kernels take, by their code in csrc/logreg_grad.cu
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def require_float(op: str, **tensors) -> None:
    """Every operand float32, bfloat16 or float16, all of one dtype."""
    dtypes = {t.dtype for t in tensors.values()}
    for name, t in tensors.items():
        if t.dtype not in DTYPES or len(dtypes) > 1:
            raise TypeError(
                f"{op}: {name} is {t.dtype} (operands: "
                f"{sorted(map(str, dtypes))}); the kernel takes float32, "
                f"bfloat16 or float16, one dtype for all operands")


def matmul_torch(a, b, transpose_a: bool = False):
    """a: (M, K), or (K, M) with ``transpose_a``; b: (K, N). Returns
    (M, N) in a's dtype, from a float32 product."""
    af, bf = a.float(), b.float()
    return torch.matmul(af.T if transpose_a else af, bf).to(a.dtype)


def margin_torch(s, y):
    """s, y: one shape. Returns v = -y * sigmoid(-y * s) in s's dtype,
    computed in float32."""
    sf, yf = s.float(), y.float()
    return (-yf * torch.sigmoid(-yf * sf)).to(s.dtype)


def _function(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("logreg_grad"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(op: str, dev, **tensors) -> None:
    require_float(op, **tensors)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{op}: {name} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous (row-major); "
                             f"pass transpose_a rather than a transposed "
                             f"view")


def matmul_cuda(a, b, transpose_a: bool = False):
    """The CUDA kernel. Same arguments and result as the plain version;
    a and b of one float dtype, contiguous, on one CUDA device."""
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
    out = torch.empty((M, N), dtype=a.dtype, device=dev)
    if M == 0 or N == 0:
        return out
    trans, code = int(bool(transpose_a)), DTYPES[a.dtype]
    scratch_bytes = ctypes.c_int64(0)
    route = _function("logreg_matmul_plan")(
        a.data_ptr(), b.data_ptr(), M, N, K, trans, code,
        ctypes.byref(scratch_bytes))
    if route < 0:
        raise RuntimeError(f"matmul kernel plan failed: error {route}")
    scratch = torch.empty(scratch_bytes.value, dtype=torch.uint8,
                          device=dev) if scratch_bytes.value else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _function("logreg_matmul")(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), M, N, K, trans,
            code, dev.index, stream)
    if err == -2:
        raise ValueError(f"matmul_cuda: ({M}, {N}) needs more tiles than "
                         f"a grid holds")
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed: error {err}")
    launches["matmul"] += 1
    designs[DESIGNS[route]] += 1
    return out


def margin_cuda(s, y):
    """The CUDA kernel. Same arguments and result as the plain version;
    s and y of one float dtype, contiguous, one shape, on one CUDA
    device."""
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
                 DTYPES[s.dtype], dev.index, stream)
    if err != 0:
        raise RuntimeError(f"margin kernel launch failed: cudaError {err}")
    launches["margin"] += 1
    return out
