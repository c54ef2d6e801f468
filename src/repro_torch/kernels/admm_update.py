"""Fused AsyBADMM worker update — eqs. (11)+(12)+(9) — in two forms.

Ports of ``repro/kernels/admm_update.py``:

* ``admm_worker_select_update_3d`` — the epoch's form, with Algorithm 1's
  sel-masked select writes of y / w_cache / x on (N, M, d) bundles:
  ``admm_worker_select_update_torch`` / ``admm_worker_select_update_cuda``;
* ``admm_worker_update_2d`` — the unmasked update with a scalar rho on a
  flat buffer, returning (x, y', w), in f32 or bf16:
  ``admm_worker_update_torch`` / ``admm_worker_update_cuda``.

Each ``*_torch`` is the plain torch version, written as its kernel
computes (``y' = -g``, ``w = rho*x + y'`` rounded in two steps, bf16
widened to f32 and each output rounded once): the CPU path, and the
yardstick the CUDA kernel is held to. Each ``*_cuda`` launches its
kernel from ``csrc/admm_update.cu`` on the tensors' device and current
stream; ``launches`` counts the launches of each, by op name.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = {"admm_worker_select_update": 0, "admm_worker_update": 0}
_fns = {}


def admm_worker_select_update_torch(g, y, z_tilde, w_old, sel, rho_vec,
                                    x_old=None):
    """g, y, z_tilde, w_old [, x_old]: (N, M, d); sel: (N, M) bool;
    rho_vec: (N,). Returns (y', w'[, x'])."""
    rho = rho_vec[:, None, None]
    x = z_tilde - (g + y) / rho
    y_new = -g
    w = rho * x + y_new
    keep = sel[..., None]
    y_out = torch.where(keep, y_new, y)
    w_out = torch.where(keep, w, w_old)
    if x_old is None:
        return y_out, w_out
    return y_out, w_out, torch.where(keep, x, x_old)


# argument types of each C entry point in csrc/admm_update.cu
_ARGTYPES = {
    "admm_worker_select_update": [ctypes.c_void_p] * 10 + [
        ctypes.c_int64] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "admm_worker_select_update_occupancy": [ctypes.c_int] * 3,
    "admm_worker_update": [ctypes.c_void_p] * 7 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


def _function(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("admm_update"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_bundle(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a contiguous tensor "
                         f"with a 16-byte aligned base")


def launch_args(launch) -> tuple:
    """(threads, blocks per SM) of a launch the autotuner chose, or (0, 0):
    the kernel's default launch."""
    if launch is None:
        return 0, 0
    threads, per_sm = (int(v) for v in launch)
    return threads, per_sm


def admm_worker_select_update_occupancy(threads: int, with_x: bool,
                                        device) -> int:
    """The most blocks of ``threads`` an SM of ``device`` holds at once of
    the select update (with or without x)."""
    dev = torch.device(device)
    return _function("admm_worker_select_update_occupancy")(
        int(threads), int(bool(with_x)), dev.index or 0)


def admm_worker_select_update_cuda(g, y, z_tilde, w_old, sel, rho_vec,
                                   x_old=None, launch=None):
    """The CUDA kernel. Same arguments and results as the plain version;
    every tensor on one CUDA device, d % 4 == 0 (the ops layer demands
    d % 128 == 0). ``launch``: (threads, blocks per SM), or None for the
    kernel's default; every launch gives the same bits."""
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"admm_worker_select_update_cuda needs CUDA "
                         f"tensors, got {dev}")
    N, M, d = g.shape
    if d % 4:
        raise ValueError(f"row width d={d} is not a multiple of 4")
    bundles = {"g": g, "y": y, "z_tilde": z_tilde, "w_old": w_old}
    if x_old is not None:
        bundles["x_old"] = x_old
    for name, t in bundles.items():
        _check_bundle(name, t, (N, M, d), dev)
    if sel.device != dev or sel.dtype != torch.bool \
            or tuple(sel.shape) != (N, M):
        raise ValueError(f"sel: expected ({N}, {M}) bool on {dev}")
    if rho_vec.device != dev or rho_vec.dtype != torch.float32 \
            or tuple(rho_vec.shape) != (N,):
        raise ValueError(f"rho_vec: expected ({N},) float32 on {dev}")
    sel_u8 = sel.contiguous().view(torch.uint8)
    rho = rho_vec.contiguous()
    y_out = torch.empty_like(g)
    w_out = torch.empty_like(g)
    x_out = torch.empty_like(g) if x_old is not None else None
    fn = _function("admm_worker_select_update")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(g.data_ptr(), y.data_ptr(), z_tilde.data_ptr(),
                 w_old.data_ptr(),
                 None if x_old is None else x_old.data_ptr(),
                 sel_u8.data_ptr(), rho.data_ptr(), y_out.data_ptr(),
                 w_out.data_ptr(),
                 None if x_out is None else x_out.data_ptr(),
                 N, M, d, *launch_args(launch), dev.index, stream)
    if err != 0:
        raise RuntimeError(f"admm_worker_select_update kernel launch "
                           f"failed: cudaError {err}")
    launches["admm_worker_select_update"] += 1
    if x_out is None:
        return y_out, w_out
    return y_out, w_out, x_out


# dtype codes of the C entry point admm_worker_update
_WORKER_UPDATE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _rho_on(rho, dev) -> torch.Tensor:
    """rho (a number or a one-element tensor) as a 0-d f32 tensor on
    ``dev``; a number is filled in on the device (no host wait)."""
    if isinstance(rho, torch.Tensor):
        if rho.numel() != 1:
            raise ValueError(f"rho: expected one value, got shape "
                             f"{tuple(rho.shape)}")
        return rho.to(device=dev, dtype=torch.float32).reshape(())
    return torch.full((), float(rho), dtype=torch.float32, device=dev)


def admm_worker_update_torch(g, y, z_tilde, rho):
    """g, y, z_tilde: one shape, f32 or bf16; rho: a number or a
    one-element tensor. Returns (x, y', w) in the inputs' dtype, computed
    in f32 and rounded once."""
    rho = _rho_on(rho, g.device)
    g32, y32, z32 = g.float(), y.float(), z_tilde.float()
    x = z32 - (g32 + y32) / rho          # a tensor rho: a true division
    y_new = -g32
    w = rho * x + y_new
    return tuple(t.to(g.dtype) for t in (x, y_new, w))


def admm_worker_update_cuda(g, y, z_tilde, rho):
    """The CUDA kernel. Same arguments and results as the plain version;
    g, y, z_tilde contiguous on one CUDA device, one dtype (f32 or bf16),
    an element count that is a multiple of 8 (the ops layer demands
    8*128)."""
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"admm_worker_update_cuda needs CUDA tensors, got "
                         f"{dev}")
    code = _WORKER_UPDATE_DTYPES.get(g.dtype)
    if code is None:
        raise TypeError(f"admm_worker_update_cuda takes float32 or "
                        f"bfloat16, got {g.dtype}")
    n = g.numel()
    if n % 8:
        raise ValueError(f"admm_worker_update_cuda: {n} elements is not a "
                         f"multiple of 8")
    for name, t in (("g", g), ("y", y), ("z_tilde", z_tilde)):
        if t.device != dev or t.dtype != g.dtype:
            raise ValueError(f"{name}: expected {g.dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(g.shape):
            raise ValueError(f"{name}: expected shape {tuple(g.shape)}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel needs a contiguous tensor "
                             f"with a 16-byte aligned base")
    rho_t = _rho_on(rho, dev)
    outs = [torch.empty_like(g) for _ in range(3)]
    fn = _function("admm_worker_update")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(g.data_ptr(), y.data_ptr(), z_tilde.data_ptr(),
                 rho_t.data_ptr(), *(o.data_ptr() for o in outs), n, code,
                 dev.index, stream)
    if err != 0:
        raise RuntimeError(f"admm_worker_update kernel launch failed: "
                           f"cudaError {err}")
    launches["admm_worker_update"] += 1
    return tuple(outs)
