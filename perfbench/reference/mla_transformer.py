"""Plain reference of a MiniCPM3-style decoder with Multi-head Latent
Attention (DeepSeek-V2's MLA, as MiniCPM3-4B uses it), in float32, from
the configuration file's sizes alone:

    x = embed[tokens]
    each layer:  x = x + MLA(rmsnorm(x)),  x = x + SwiGLU(rmsnorm(x))
    logits = rmsnorm(x) @ lm_head,  loss = mean token cross-entropy

MLA: c_q = rmsnorm(h W_dq), q = c_q W_uq split per head into q_nope
(qk_nope_head_dim) and q_rope (qk_rope_head_dim, rotated); [c_kv,
k_rope] = h W_dkv, c_kv normed, k_rope rotated and shared by all heads;
k_nope = c_kv W_uk, v = c_kv W_uv; scores (q_nope . k_nope + q_rope .
k_rope) / sqrt(qk_nope + qk_rope), causal softmax, then W_o.

Departures from the published model, each as the configuration file's
``reduced`` lists them: no muP scalars (scale_emb, scale_depth,
dim_model_base), plain RoPE (theta 10000) without LongRoPE's factors.
RoPE rotates interleaved channel pairs (2i, 2i + 1), where the
published code pairs channel i with i + rope/2: the two differ by a
fixed permutation of the rope channels of W_uq and W_dkv, so on random
weights they are the same function class.

Weights keep the (in, out) layout, ``x @ W``. ``tf32=True`` rounds
both operands of every matrix product to TF32 (10 mantissa bits, to
nearest even) before a float32 product: the control, one precision
below the configuration's float32 with TF32 off.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Path = Tuple[str, ...]


def dims(cfg: Dict) -> Dict[str, int]:
    return dict(d=cfg["hidden_size"], L=cfg["num_hidden_layers"],
                nq=cfg["num_attention_heads"], ff=cfg["intermediate_size"],
                V=cfg["vocab_size"], ql=cfg["q_lora_rank"],
                kvl=cfg["kv_lora_rank"], nope=cfg["qk_nope_head_dim"],
                rope=cfg["qk_rope_head_dim"], vd=cfg["v_head_dim"])


def param_shapes(cfg: Dict) -> Dict[Path, Tuple[Tuple[int, ...], tuple]]:
    """Every leaf's path, shape and init; layer leaves stacked on a
    leading L axis."""
    k = dims(cfg)
    d, L, nq = k["d"], k["L"], k["nq"]
    qk = k["nope"] + k["rope"]
    dense = lambda *shape: (shape, ("dense", shape[-2]))     # noqa: E731
    ones = lambda *shape: (shape, ("ones",))                 # noqa: E731
    return {
        ("embed",): ((k["V"], d), ("embed",)),
        ("final_norm",): ones(d),
        ("lm_head",): dense(d, k["V"]),
        ("layers", "attn", "w_dq"): dense(L, d, k["ql"]),
        ("layers", "attn", "q_norm"): ones(L, k["ql"]),
        ("layers", "attn", "w_uq"): dense(L, k["ql"], nq * qk),
        ("layers", "attn", "w_dkv"): dense(L, d, k["kvl"] + k["rope"]),
        ("layers", "attn", "kv_norm"): ones(L, k["kvl"]),
        ("layers", "attn", "w_uk"): dense(L, k["kvl"], nq * k["nope"]),
        ("layers", "attn", "w_uv"): dense(L, k["kvl"], nq * k["vd"]),
        ("layers", "attn", "w_o"): dense(L, nq * k["vd"], d),
        ("layers", "norm1"): ones(L, d),
        ("layers", "norm2"): ones(L, d),
        ("layers", "mlp", "w_gate"): dense(L, d, k["ff"]),
        ("layers", "mlp", "w_up"): dense(L, d, k["ff"]),
        ("layers", "mlp", "w_down"): dense(L, k["ff"], d),
    }


def tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` (float32) rounded to TF32: 10 mantissa bits, to nearest
    even."""
    bits = a.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    return ((bits + 0xFFF + keep) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, in the backward's two
    products too, as a TF32 matrix unit computes all three."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32(a), tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32(g)
        return ((rg @ rb.transpose(-1, -2)).sum_to_size(ra.shape),
                (ra.transpose(-1, -2) @ rg).sum_to_size(rb.shape))


def _mm(a, b, round_tf32: bool):
    return _TF32MatMul.apply(a, b) if round_tf32 else a @ b


def _rmsnorm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def _rope(x, theta):
    """x (B, S, H, r): pairs (2i, 2i + 1) rotated by position * theta^(-2i/r)."""
    S, r = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, r, 2, dtype=torch.float32,
                                       device=x.device) / r)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(x.shape)


def loss(p: Dict[Path, torch.Tensor], tokens, labels, cfg: Dict,
         round_tf32: bool = False) -> torch.Tensor:
    """Mean cross-entropy of (B, S) ``labels`` after (B, S) ``tokens``;
    ``p`` maps each path of ``param_shapes`` to its tensor."""
    k = dims(cfg)
    eps, theta = float(cfg["rms_norm_eps"]), float(cfg["rope_theta"])
    nq, nope, rope, vd, kvl = k["nq"], k["nope"], k["rope"], k["vd"], k["kvl"]
    mm = lambda a, b: _mm(a, b, round_tf32)                  # noqa: E731
    B, S = tokens.shape
    scale = 1.0 / math.sqrt(nope + rope)
    causal = torch.ones((S, S), dtype=torch.bool,
                        device=tokens.device).tril()
    x = p[("embed",)][tokens]
    for l in range(k["L"]):
        a = lambda name: p[("layers", "attn", name)][l]      # noqa: E731
        h = _rmsnorm(x, p[("layers", "norm1")][l], eps)
        cq = _rmsnorm(mm(h, a("w_dq")), a("q_norm"), eps)
        q = mm(cq, a("w_uq")).view(B, S, nq, nope + rope)
        q_nope, q_rope = q[..., :nope], _rope(q[..., nope:], theta)
        dkv = mm(h, a("w_dkv"))
        c_kv = _rmsnorm(dkv[..., :kvl], a("kv_norm"), eps)
        k_rope = _rope(dkv[..., kvl:][:, :, None, :], theta)   # (B, S, 1, r)
        k_nope = mm(c_kv, a("w_uk")).view(B, S, nq, nope)
        v = mm(c_kv, a("w_uv")).view(B, S, nq, vd)
        scores = (mm(q_nope.transpose(1, 2), k_nope.permute(0, 2, 3, 1))
                  + mm(q_rope.transpose(1, 2), k_rope.permute(0, 2, 3, 1)))
        scores = (scores * scale).masked_fill(~causal, -torch.inf)
        probs = torch.softmax(scores, dim=-1)
        out = mm(probs, v.transpose(1, 2)).transpose(1, 2).reshape(B, S, -1)
        x = x + mm(out, a("w_o"))
        h = _rmsnorm(x, p[("layers", "norm2")][l], eps)
        m = lambda name: p[("layers", "mlp", name)][l]       # noqa: E731
        gate = mm(h, m("w_gate"))
        x = x + mm(gate * torch.sigmoid(gate) * mm(h, m("w_up")),
                   m("w_down"))
    x = _rmsnorm(x, p[("final_norm",)], eps)
    logits = mm(x, p[("lm_head",)])
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)
