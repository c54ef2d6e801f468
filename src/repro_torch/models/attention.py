"""Grouped-query attention — the GQA half of ``repro/models/attention.py``.

Supports MHA / GQA (grouped KV heads), QKV bias (Qwen1.5 / ChatGLM),
qk-norm (Qwen3 / Chameleon), partial RoPE (ChatGLM "2d") and a sliding
window, with two attention implementations: ``naive`` (the (S, T)
scores materialized, ``_sdpa``) and ``flash`` (kernel B7 through
``ops.flash_attention``, ``_sdpa_flash``). The reference's ``chunked``
and ``qchunk`` implementations, MLA and cross-attention wait for their
slice (ROADMAP Queue A item 11) and raise ``NotImplementedError``.

Two entry points:
  gqa_forward : full sequence (prefill), causal;
  gqa_decode  : one token against a KV cache of (B, max_len, nkv, hd).

``gqa_decode`` writes the new position into the cache in place and
returns the same tensors, where the reference returns a new cache.

Each scaling is the reference's: ``_sdpa`` divides the scores by
sqrt(hd); the flash path multiplies by 1/sqrt(hd) of the unpadded hd.
"""
from __future__ import annotations

import math

import torch

from ..kernels import ops
from .layers import apply_rope, causal_mask, dense_init, rmsnorm

NOT_PORTED = "ROADMAP Queue A item 11"


# --------------------------------------------------------------------------
# parameter init
# --------------------------------------------------------------------------

def init_attention(gen, cfg, *, cross: bool = False, device=None):
    if cross:
        raise NotImplementedError(
            f"cross-attention (enc-dec archs) is not ported yet ({NOT_PORTED})")
    if cfg.mla is not None:
        raise NotImplementedError(
            f"MLA attention is not ported yet ({NOT_PORTED})")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dt = cfg.torch_param_dtype()
    p = {
        "w_q": dense_init(gen, d, nq * hd, dt, device=device),
        "w_k": dense_init(gen, d, nkv * hd, dt, device=device),
        "w_v": dense_init(gen, d, nkv * hd, dt, device=device),
        "w_o": dense_init(gen, nq * hd, d, dt, device=device),
    }
    if cfg.qkv_bias:
        p["b_q"] = torch.zeros((nq * hd,), dtype=dt, device=device)
        p["b_k"] = torch.zeros((nkv * hd,), dtype=dt, device=device)
        p["b_v"] = torch.zeros((nkv * hd,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=device)
    return p


# --------------------------------------------------------------------------
# GQA core
# --------------------------------------------------------------------------

def _project_qkv(params, x, cfg, positions, *, rope: bool = True):
    B, S, _ = x.shape
    hd, nq, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    q = x @ params["w_q"]
    k = x @ params["w_k"]
    v = x @ params["w_v"]
    if cfg.qkv_bias:
        q, k, v = q + params["b_q"], k + params["b_k"], v + params["b_v"]
    q = q.reshape(B, S, nq, hd)
    k = k.reshape(B, S, nkv, hd)
    v = v.reshape(B, S, nkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def _sdpa(q, k, v, mask, nq, nkv):
    """q: (B,S,nq,hd) k/v: (B,T,nkv,hd); mask broadcastable (S,T) or None."""
    hd = q.shape[-1]
    group = nq // nkv
    B, S = q.shape[:2]
    q = q.reshape(B, S, nkv, group, hd)
    scores = torch.einsum("bsngh,btnh->bngst", q, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask[None, None, None, :, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bngst,btnh->bsngh", probs, v)
    return out.reshape(B, S, nq * hd)


def _sdpa_flash(q, k, v, nq, nkv, *, causal=True):
    """Attention through kernel B7 (``ops.flash_attention``): the GQA kv
    heads expanded, S padded to a multiple of 128 and hd to a multiple of
    128 (at least 128), as the reference pads for its Pallas kernel, and
    the scale 1/sqrt(hd) of the unpadded hd. Requires no sliding window.

    The padded keys are zeros that the causal mask hides from every real
    row; with ``causal=False`` they are not masked and take part in the
    softmax, as in the reference (ROADMAP Queue C)."""
    B, S, _, hd = q.shape
    group = nq // nkv
    kr = torch.repeat_interleave(k, group, dim=2)    # expand GQA kv heads
    vr = torch.repeat_interleave(v, group, dim=2)
    scale = 1.0 / (hd ** 0.5)
    pad_s = (-S) % 128
    hd_p = max(128, -(-hd // 128) * 128)

    def prep(t):
        t = torch.nn.functional.pad(t, (0, hd_p - hd, 0, 0, 0, pad_s))
        return t.transpose(1, 2).reshape(B * nq, S + pad_s,
                                         hd_p).contiguous()

    out = ops.flash_attention(prep(q), prep(kr), prep(vr), causal, scale)
    out = out.reshape(B, nq, S + pad_s, hd_p)[:, :, :S, :hd]
    return out.transpose(1, 2).reshape(B, S, nq * hd)


def gqa_forward(params, x, cfg, positions, *, window=None):
    if cfg.attn_impl in ("chunked", "qchunk"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported yet ({NOT_PORTED}); "
            f"the port has 'naive' and 'flash'")
    q, k, v = _project_qkv(params, x, cfg, positions)
    S = x.shape[1]
    if cfg.attn_impl == "flash" and window is None:
        out = _sdpa_flash(q, k, v, cfg.num_heads, cfg.num_kv_heads)
    else:
        mask = causal_mask(S, S, 0, window, device=x.device)
        out = _sdpa(q, k, v, mask, cfg.num_heads, cfg.num_kv_heads)
    return out @ params["w_o"]


def gqa_decode(params, x, cfg, cache, pos: int):
    """x: (B,1,d); cache: {"k","v"} of shape (B, max_len, nkv, hd); pos —
    the number of tokens already in the cache. The new K/V are written in
    place at ``pos``, or at the last slot once ``pos`` reaches max_len:
    the reference's ``dynamic_update_slice`` clamps its start so. The
    mask uses the true ``pos``. Window masking is applied logically, as
    in the reference."""
    pos = int(pos)
    positions = torch.full(x.shape[:2], pos, dtype=torch.int64,
                           device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    ck, cv = cache["k"], cache["v"]
    T = ck.shape[1]
    at = min(pos, T - 1)
    ck[:, at:at + 1] = k
    cv[:, at:at + 1] = v
    kj = torch.arange(T, device=x.device)
    m = kj <= pos
    if cfg.sliding_window is not None:
        m = m & (kj > pos - cfg.sliding_window)
    out = _sdpa(q, ck, cv, m[None, :], cfg.num_heads, cfg.num_kv_heads)
    return out @ params["w_o"], {"k": ck, "v": cv}


def gqa_cache_spec(cfg, batch: int, max_len: int):
    """{"k", "v"}: (shape, dtype) of one layer's cache."""
    hd, nkv = cfg.resolved_head_dim, cfg.num_kv_heads
    if cfg.sliding_window is not None:
        max_len = min(max_len, cfg.sliding_window)
    shape = (batch, max_len, nkv, hd)
    return {"k": (shape, cfg.torch_dtype()), "v": (shape, cfg.torch_dtype())}
