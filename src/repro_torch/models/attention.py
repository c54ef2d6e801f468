"""Attention variants — a port of ``repro/models/attention.py``.

Supports MHA / GQA (grouped KV heads), QKV bias (Qwen1.5 / ChatGLM),
qk-norm (Qwen3 / Chameleon), partial RoPE (ChatGLM "2d"), a sliding
window (Mixtral), cross-attention (Whisper's decoder) and MLA —
Multi-head Latent Attention (MiniCPM3), with the *absorbed* decode that
attends over the latent cache. GQA has two attention implementations:
``naive`` (the (S, T) scores materialized, ``_sdpa``) and ``flash``
(kernel B7 through ``ops.flash_attention``, ``_sdpa_flash``). The
reference's ``chunked`` and ``qchunk`` implementations wait for their
slice (ROADMAP Queue A item 11 step 6) and raise
``NotImplementedError``. MLA and cross-attention materialize their
scores whatever ``attn_impl`` says, as the reference's do: they reach
no kernel.

Entry points:
  gqa_forward / mla_forward : full sequence (prefill, training);
  gqa_decode / mla_decode   : one token against a cache;
  cross_attn_forward        : decoder queries against the encoder's
                              K/V (``encode_cross_kv``), unmasked.

The decodes write the new position into the cache in place and return
the same tensors, where the reference returns a new cache. MLA's decode
is not its prefill's arithmetic: the prefill expands the latent into
K/V (``c_kv @ W_uk``, ``c_kv @ W_uv``); the decode folds ``W_uk`` into
the query and ``W_uv`` after the attention, over the cache of ``c_kv``
and the one shared rope head ``k_rope``.

Each scaling is the reference's: ``_sdpa`` divides the scores by
sqrt(hd); the flash path multiplies by 1/sqrt(hd) of the unpadded hd;
MLA multiplies by 1/sqrt(qk_nope + qk_rope) rounded to float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels import ops
from .layers import apply_rope, causal_mask, dense_init, rmsnorm

NOT_PORTED = "ROADMAP Queue A item 11 step 6"


# --------------------------------------------------------------------------
# parameter init
# --------------------------------------------------------------------------

def init_attention(gen, cfg, *, cross: bool = False, device=None):
    """One layer's attention weights: MLA's when ``cfg.mla`` is set,
    else GQA's (cross-attention is always GQA)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dt = cfg.torch_param_dtype()
    if cfg.mla is not None and not cross:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "w_dq": dense_init(gen, d, m.q_lora_rank, dt, device=device),
            "q_norm": torch.ones((m.q_lora_rank,), dtype=dt, device=device),
            "w_uq": dense_init(gen, m.q_lora_rank, nq * qk_dim, dt,
                               device=device),
            "w_dkv": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                                dt, device=device),
            "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dt,
                                  device=device),
            "w_uk": dense_init(gen, m.kv_lora_rank, nq * m.qk_nope_head_dim,
                               dt, device=device),
            "w_uv": dense_init(gen, m.kv_lora_rank, nq * m.v_head_dim, dt,
                               device=device),
            "w_o": dense_init(gen, nq * m.v_head_dim, d, dt, device=device),
        }
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


def gqa_forward(params, x, cfg, positions, *, window=None, causal=True):
    """Self-attention over the sequence; ``causal=False`` (the enc-dec
    encoder) masks nothing, and ignores ``window`` as the reference
    does."""
    if cfg.attn_impl in ("chunked", "qchunk"):
        raise NotImplementedError(
            f"attn_impl={cfg.attn_impl!r} is not ported yet ({NOT_PORTED}); "
            f"the port has 'naive' and 'flash'")
    q, k, v = _project_qkv(params, x, cfg, positions)
    S = x.shape[1]
    if cfg.attn_impl == "flash" and window is None:
        out = _sdpa_flash(q, k, v, cfg.num_heads, cfg.num_kv_heads,
                          causal=causal)
    else:
        mask = causal_mask(S, S, 0, window, device=x.device) if causal \
            else None
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


# --------------------------------------------------------------------------
# cross attention (Whisper decoder)
# --------------------------------------------------------------------------

def cross_attn_forward(params, x, enc_kv, cfg):
    """Queries of ``x`` (no bias, norm or rope) against ``enc_kv`` = (k,
    v) precomputed from the encoder's output, unmasked."""
    B, S, _ = x.shape
    hd, nq, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    q = (x @ params["w_q"]).reshape(B, S, nq, hd)
    k, v = enc_kv
    return _sdpa(q, k, v, None, nq, nkv) @ params["w_o"]


def encode_cross_kv(params, enc_out, cfg):
    """One decoder layer's cross K/V of the encoder output: (B, T_enc,
    nkv, hd) each."""
    B, T, _ = enc_out.shape
    hd, nkv = cfg.resolved_head_dim, cfg.num_kv_heads
    k = (enc_out @ params["w_k"]).reshape(B, T, nkv, hd)
    v = (enc_out @ params["w_v"]).reshape(B, T, nkv, hd)
    return k, v


# --------------------------------------------------------------------------
# MLA — Multi-head Latent Attention
# --------------------------------------------------------------------------

def _mla_scale(m) -> float:
    """1/sqrt(qk_nope + qk_rope), each step in float32 as the
    reference's ``1.0 / jnp.sqrt(dim)``."""
    return float(np.float32(1.0) / np.sqrt(np.float32(
        m.qk_nope_head_dim + m.qk_rope_head_dim)))


def _mla_q(params, x, cfg, positions):
    """(q_nope, q_rope) of (B, S, nq, ·): the query through its low-rank
    bottleneck; the rope part rotated in full (MLA takes no
    ``rope_fraction``)."""
    m = cfg.mla
    B, S, _ = x.shape
    cq = rmsnorm(x @ params["w_dq"], params["q_norm"], cfg.norm_eps)
    q = (cq @ params["w_uq"]).reshape(
        B, S, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(params, x, cfg, positions):
    """(c_kv (B, S, rank), k_rope (B, S, rope)): the normed KV latent and
    the single rope head shared by all heads, roped as (B, S, 1, rope)."""
    m = cfg.mla
    dkv = x @ params["w_dkv"]
    c_kv = rmsnorm(dkv[..., :m.kv_lora_rank], params["kv_norm"],
                   cfg.norm_eps)
    k_rope = apply_rope(dkv[..., m.kv_lora_rank:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _mla_softmax(scores, mask, scale, dtype):
    """The reference's ``softmax(where(mask, (scores).astype(f32) *
    scale, -1e30))``, its scale and mask written in place: an (B, nq, S,
    T) float32 tensor is 10.7 GB at minicpm3-4b's 40 heads and 4 x 4096
    (the in-place steps are ones autograd can differentiate)."""
    scores = scores.float().mul_(scale).masked_fill_(~mask, -1e30)
    return torch.softmax(scores, dim=-1).to(dtype)


def mla_forward(params, x, cfg, positions):
    """The materialized K/V path, for prefill and training: the latent
    expanded into K_nope and V, causal scores of q_nope . k_nope plus
    q_rope . k_rope."""
    m = cfg.mla
    B, S, _ = x.shape
    nq = cfg.num_heads
    q_nope, q_rope = _mla_q(params, x, cfg, positions)
    c_kv, k_rope = _mla_latent(params, x, cfg, positions)
    k_nope = (c_kv @ params["w_uk"]).reshape(B, S, nq, m.qk_nope_head_dim)
    v = (c_kv @ params["w_uv"]).reshape(B, S, nq, m.v_head_dim)
    scores = torch.einsum("bsnh,btnh->bnst", q_nope, k_nope)
    scores = scores.add_(torch.einsum("bsnh,bth->bnst", q_rope, k_rope))
    probs = _mla_softmax(scores, causal_mask(S, S, 0, device=x.device),
                         _mla_scale(m), v.dtype)
    del scores
    out = torch.einsum("bnst,btnh->bsnh", probs, v).reshape(B, S, -1)
    return out @ params["w_o"]


def mla_decode(params, x, cfg, cache, pos: int):
    """The absorbed decode: x (B, 1, d) against the latent cache
    {"c_kv": (B, max_len, rank), "k_rope": (B, max_len, rope)}, written in
    place at ``pos`` (at the last slot past max_len, as ``gqa_decode``).
    score = (q_nope W_uk) . c_kv + q_rope . k_rope; the context over
    c_kv, then W_uv."""
    m = cfg.mla
    pos = int(pos)
    B, nq = x.shape[0], cfg.num_heads
    positions = torch.full(x.shape[:2], pos, dtype=torch.int64,
                           device=x.device)
    q_nope, q_rope = _mla_q(params, x, cfg, positions)      # (B,1,nq,.)
    c_new, kr_new = _mla_latent(params, x, cfg, positions)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    T = c_kv.shape[1]
    at = min(pos, T - 1)
    c_kv[:, at:at + 1] = c_new
    k_rope[:, at:at + 1] = kr_new
    w_uk = params["w_uk"].reshape(m.kv_lora_rank, nq, m.qk_nope_head_dim)
    q_abs = torch.einsum("bsnh,rnh->bsnr", q_nope, w_uk)   # (B,1,nq,rank)
    scores = torch.einsum("bsnr,btr->bnst", q_abs, c_kv)
    scores = scores.add_(torch.einsum("bsnh,bth->bnst", q_rope, k_rope))
    mask = torch.arange(T, device=x.device)[None, :] <= pos
    probs = _mla_softmax(scores, mask, _mla_scale(m), x.dtype)
    ctx = torch.einsum("bnst,btr->bsnr", probs, c_kv)      # (B,1,nq,rank)
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, nq, m.v_head_dim)
    out = torch.einsum("bsnr,rnh->bsnh", ctx, w_uv).reshape(B, 1, -1)
    return out @ params["w_o"], {"c_kv": c_kv, "k_rope": k_rope}


def mla_cache_spec(cfg, batch: int, max_len: int):
    """{"c_kv", "k_rope"}: (shape, dtype) of one layer's latent cache."""
    m, dt = cfg.mla, cfg.torch_dtype()
    return {"c_kv": ((batch, max_len, m.kv_lora_rank), dt),
            "k_rope": ((batch, max_len, m.qk_rope_head_dim), dt)}
