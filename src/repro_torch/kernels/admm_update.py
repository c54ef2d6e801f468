"""Fused AsyBADMM worker update — eqs. (11)+(12)+(9) — with Algorithm 1's
sel-masked select writes of y / w_cache / x.

Port of ``repro/kernels/admm_update.py::admm_worker_select_update_3d``.
Two implementations of one function:

* ``admm_worker_select_update_torch`` — the plain torch version, written
  as the kernel computes (``y' = -g``, ``w = rho*x + y'`` rounded in two
  steps). The CPU path, and the yardstick the CUDA kernel is held to;
* ``admm_worker_select_update_cuda`` — launches ``csrc/admm_update.cu``
  on the tensors' device and current stream. ``launches`` counts its
  launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
_fn = None


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


def _function():
    global _fn
    if _fn is None:
        fn = _build.load("admm_update").admm_worker_select_update
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 3 + [
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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


def admm_worker_select_update_cuda(g, y, z_tilde, w_old, sel, rho_vec,
                                   x_old=None):
    """The CUDA kernel. Same arguments and results as the plain version;
    every tensor on one CUDA device, d % 4 == 0 (the ops layer demands
    d % 128 == 0)."""
    global launches
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
    fn = _function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(g.data_ptr(), y.data_ptr(), z_tilde.data_ptr(),
                 w_old.data_ptr(),
                 None if x_old is None else x_old.data_ptr(),
                 sel_u8.data_ptr(), rho.data_ptr(), y_out.data_ptr(),
                 w_out.data_ptr(),
                 None if x_out is None else x_out.data_ptr(),
                 N, M, d, dev.index, stream)
    if err != 0:
        raise RuntimeError(f"admm_worker_select_update kernel launch "
                           f"failed: cudaError {err}")
    launches += 1
    if x_out is None:
        return y_out, w_out
    return y_out, w_out, x_out
