"""Flash attention (B7): causal or full softmax attention on (BH, S, hd)
without the (S, T) scores in device memory.

Port of ``repro/kernels/flash_attention.py::flash_attention_bhsd``:

* ``flash_attention_torch`` — the plain version: the full softmax in
  float32 with the kernel's mask and scale (scores ``q kᵀ * scale``,
  masked to -1e30 above the diagonal under ``causal``), cast back to q's
  dtype; the reference test's oracle (``tests/test_flash_attention.py``).
  The CPU path, and the yardstick the kernel is held to;
* ``flash_attention_cuda`` — launches ``csrc/flash_attention.cu`` on the
  tensors' device and current stream, on the tensor cores: in bfloat16
  and float16 wgmma on TMA-loaded tiles (one block per (bh, 128-row q
  tile), P rounded to the input type before P V), in float32 3xTF32
  mma.sync (one block per (bh, 64-row q tile)); an online softmax with
  m, l and the output accumulator in float32 registers, K tiles wholly
  above the diagonal skipped under ``causal``. ``launches`` counts its
  launches.

q is (BH, S, hd) and k, v are (BH, T, hd), one dtype (float32, bfloat16
or float16), contiguous and 16-byte aligned (TMA and cp.async copy
16-byte units); GQA heads are expanded by the caller. The
kernel takes head dims 128 and 256 (the model path pads hd to a multiple
of 128, ``models.attention._sdpa_flash``) and any S and T; a key past T
does not exist for it. ``scale`` defaults to 1/sqrt(hd).

Where the two versions differ: a NaN or Inf in v at a key that a causal
row never sees reaches that row in the plain version (0 * NaN in the
product with the probabilities) and in the reference's kernel, which
visits every K tile; the CUDA kernel skips the tiles above the diagonal,
so it reaches only the rows of the tiles it visits. With finite inputs
the skip changes nothing: the first K tile holds a valid key for every
row, so m is finite from there on, and a wholly masked tile would add
exp(-1e30 - m) = 0 with a correction of exactly 1.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIMS = (128, 256)          # the kernel's instantiations
# the element types the kernel takes, by their code in the source
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

launches = {"flash_attention": 0}
_fns = {}


def _scale(hd: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(hd) if scale is None else float(scale)


def flash_attention_torch(q, k, v, causal: bool = True,
                          scale: Optional[float] = None):
    """q: (BH, S, hd); k, v: (BH, T, hd). Returns (BH, S, hd) in q's
    dtype."""
    S, T = q.shape[1], k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    s = s * _scale(q.shape[-1], scale)
    if causal:
        mask = torch.ones((S, T), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _function():
    fn = _fns.get("flash_attention")
    if fn is None:
        fn = _build.load("flash_attention").flash_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns["flash_attention"] = fn
    return fn


def check_operands(op: str, q, k, v) -> None:
    """Shapes, dtypes and head dim the kernel takes; raises otherwise."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"{op}: expected (BH, S, hd) operands, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    BH, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != hd:
        raise ValueError(f"{op}: q {tuple(q.shape)} and k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit (BH, S, hd) and "
                         f"(BH, T, hd)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{op}: q, k, v are {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes float32, bfloat16 or "
                        f"float16, one dtype for all three")


def flash_attention_cuda(q, k, v, causal: bool = True,
                         scale: Optional[float] = None):
    """The CUDA kernel. Same arguments and result as the plain version;
    q, k, v contiguous on one CUDA device, head dim 128 or 256."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    check_operands("flash_attention_cuda", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention_cuda: {name} is on {t.device}, "
                             f"expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_cuda: {name} must be "
                             f"contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} must start on "
                             f"a 16-byte boundary (a view at an offset "
                             f"does not)")
    BH, S, hd = q.shape
    T = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {hd}; the kernel "
                         f"takes {HEAD_DIMS} (pad hd as _sdpa_flash does)")
    out = torch.empty_like(q)
    if BH == 0 or S == 0:
        return out
    if T == 0:                  # nothing to attend to: acc = 0, l = 0
        return out.zero_()
    fn = _function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 BH, S, T, hd, _scale(hd, scale), int(bool(causal)),
                 DTYPES[q.dtype], dev.index, stream)
    if err == -2:
        raise ValueError(f"flash_attention_cuda: (BH={BH}, S={S}, T={T}) "
                         f"needs more blocks than a grid holds")
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"cudaError {err}")
    launches["flash_attention"] += 1
    return out
