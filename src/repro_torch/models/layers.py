"""Core layer primitives: inits, norms, rotary embeddings, MLPs — a port
of ``repro/models/layers.py``.

Weights keep the reference's (in, out) layout and are applied as
``x @ w``. What is easy to get wrong against the reference:

* ``apply_rope`` rotates *interleaved* pairs (``x[..., 0::2]`` with
  ``x[..., 1::2]``), not the half-split pairs most PyTorch code uses;
* partial RoPE rotates the first ``rot_dim`` channels, ``rot_dim`` being
  ``int(head_dim * fraction)`` rounded down to even (``rope_freqs``);
* ``rmsnorm`` computes in float32 and casts back to the input's dtype;
* ``jax.nn.gelu`` is the tanh approximation, so ``approximate="tanh"``.

The inits draw the reference's distributions from a ``torch.Generator``;
the numbers differ from JAX's threefry draws.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def dense_init(gen: Optional[torch.Generator], in_dim: int, out_dim: int,
               dtype, scale: Optional[float] = None, device=None):
    """N(0, 1) * scale (1/sqrt(in_dim) by default), (in_dim, out_dim),
    drawn on ``device`` (``gen``'s device by default; ``gen`` may be None
    on the meta device)."""
    if scale is None:
        scale = 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen,
                    device=device or gen.device)
    return (w * scale).to(dtype)


def embed_init(gen: Optional[torch.Generator], vocab: int, dim: int, dtype,
               device=None):
    w = torch.randn((vocab, dim), generator=gen, device=device or gen.device)
    return (w * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm(x, weight, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(dt)


def rmsnorm_gated(x, weight, gate, eps: float = 1e-5):
    """Mamba2 gated RMSNorm: norm(x * silu(gate))."""
    return rmsnorm(x * F.silu(gate.float()).to(x.dtype), weight, eps)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None):
    """Return inverse frequencies for the rotary fraction of the head dim.

    ``fraction < 1`` implements partial rotary ("2d RoPE", ChatGLM style):
    only the first ``fraction * head_dim`` channels rotate.
    """
    rot_dim = int(head_dim * fraction)
    rot_dim -= rot_dim % 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    inv = 1.0 / (theta ** exps)
    return inv, rot_dim


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers."""
    head_dim = x.shape[-1]
    inv, rot_dim = rope_freqs(head_dim, theta, fraction, device=x.device)
    if rot_dim == 0:
        return x
    ang = positions[..., :, None].float() * inv        # (..., seq, rot/2)
    cos = torch.cos(ang)[..., :, None, :]              # (..., seq, 1, rot/2)
    sin = torch.sin(ang)[..., :, None, :]
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str, dtype,
             device=None):
    if act == "swiglu":
        return {
            "w_gate": dense_init(gen, d_model, d_ff, dtype, device=device),
            "w_up": dense_init(gen, d_model, d_ff, dtype, device=device),
            "w_down": dense_init(gen, d_ff, d_model, dtype, device=device),
        }
    return {
        "w_up": dense_init(gen, d_model, d_ff, dtype, device=device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device=device),
    }


def mlp(params, x, act: str = "swiglu"):
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


# --------------------------------------------------------------------------
# misc
# --------------------------------------------------------------------------

def causal_mask(q_len: int, kv_len: int, q_offset, window: Optional[int] = None,
                device=None):
    """Boolean (q_len, kv_len) mask. q position i sits at absolute index
    q_offset + i; kv index j is absolute j.  window = sliding-window width."""
    qi = q_offset + torch.arange(q_len, device=device)[:, None]
    kj = torch.arange(kv_len, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m


def cross_entropy(logits, labels, label_mask=None):
    """Mean token cross-entropy. logits: (B, S, V); labels: (B, S) integers."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if label_mask is not None:
        return torch.sum(nll * label_mask) / torch.clamp_min(
            torch.sum(label_mask), 1.0)
    return torch.mean(nll)
