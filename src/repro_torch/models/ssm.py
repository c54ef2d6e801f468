"""Mamba2 — state-space duality (SSD) block [arXiv:2405.21060], a port
of ``repro/models/ssm.py``.

Training and prefill use the chunked SSD algorithm: quadratic
attention-like work *within* chunks of length Q plus a linear
recurrence *across* chunks, giving O(L·Q) work and O(1)-state decode.
Decode is the pure SSM recurrence: one state update per token.

Layout notation: b=batch, l=seq, c=chunks, q=chunk pos, h=heads,
p=head channels, n=state dim, g=groups (g=1, broadcast to h).

What differs from the reference in form, not in value:

* the reference's three-operand einsums are two-operand steps (an
  elementwise product, then one batched matmul), so no (b, c, i, j, h,
  p) product is built; the intra-chunk decay is laid out (b, c, h, i,
  j), heads outside the chunk positions, so the cumsum along Q runs down
  the innermost axis and the product with dt·x is one batched matmul
  per (b, c, h);
* the cross-chunk scan is a Python loop over the chunks;
* ``mamba2_decode`` writes the new conv and SSM states into the cache
  it is given, in place (the serving cache's slot of the layer), and
  returns the same tensors, where the reference returns new ones.

As in the reference, the causal mask is applied to the decay's exponent
*before* the ``exp``: for j > i the difference is positive and
overflows, and inf·0 is NaN in the backward pass.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense_init, rmsnorm_gated


def _dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.state_dim  # x + B + C (g=1)
    return d_inner, nheads, conv_dim


def init_mamba2(gen, cfg, device=None):
    """The reference's distributions, drawn from ``gen`` in the order
    w_in, conv_w, w_out (the numbers differ from threefry's)."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner, nheads, conv_dim = _dims(cfg)
    dt = cfg.torch_param_dtype()
    device = device if device is not None else gen.device
    in_dim = 2 * d_inner + 2 * s.state_dim + nheads  # z, xBC, dt
    w_in = dense_init(gen, d, in_dim, dt, device=device)
    conv_w = (torch.randn((s.conv_width, conv_dim), generator=gen,
                          device=device) * 0.1).to(dt)
    w_out = dense_init(gen, d_inner, d, dt, device=device)
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads,
                                          device=device)).to(dt),
        "D": torch.ones((nheads,), dtype=dt, device=device),
        "dt_bias": torch.zeros((nheads,), dtype=dt, device=device),
        "norm_w": torch.ones((d_inner,), dtype=dt, device=device),
        "w_out": w_out,
    }


def _split_in(params, u, cfg):
    d_inner, _, conv_dim = _dims(cfg)
    zxbcdt = u @ params["w_in"]
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim:]
    return z, xBC, dt_raw


def _causal_conv(params, xBC, cfg, conv_state=None):
    """Depthwise causal conv over seq. conv_state: (B, W-1, conv_dim) or
    None. The new state is a view of a fresh concatenation, never of
    ``conv_state``."""
    W = cfg.ssm.conv_width
    if conv_state is None:
        pad = xBC.new_zeros((xBC.shape[0], W - 1, xBC.shape[-1]))
    else:
        pad = conv_state
    xp = torch.cat([pad, xBC], dim=1)                    # (B, L+W-1, C)
    L = xBC.shape[1]
    out = sum(xp[:, i:i + L, :] * params["conv_w"][i] for i in range(W))
    out = F.silu(out + params["conv_b"])
    new_state = xp[:, -(W - 1):, :]
    return out, new_state


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """Chunked SSD scan.
    x: (b,l,h,p)  dt: (b,l,h)  A: (h,)  B,C: (b,l,n)  (g=1, broadcast to h)
    Returns y: (b,l,h,p), final_state: (b,h,n,p)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, l)
    pad = (-l) % Q
    if pad:
        # the pads carry dt = 0: they neither decay nor feed the state
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    L = l + pad
    nc = L // Q
    xc = x.reshape(b, nc, Q, h, p)
    dtc = dt.reshape(b, nc, Q, h)
    Bc = B.reshape(b, nc, Q, n)
    Cc = C.reshape(b, nc, Q, n)

    # heads outside the chunk positions: (b, nc, h, Q)
    dA = (dtc * A).transpose(2, 3)                       # negative
    cum = torch.cumsum(dA, dim=-1)
    # intra-chunk: (scores ∘ decay ∘ causal) @ (dt*x), the exponent
    # masked BEFORE exp
    diff = cum[..., :, None] - cum[..., None, :]         # (b,nc,h,i,j)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    diff = torch.where(causal, diff, -torch.inf)
    decay = torch.exp(diff)
    scores = Cc @ Bc.transpose(-1, -2)                   # (b,nc,i,j)
    dtx = xc * dtc[..., None]                            # (b,nc,Q,h,p)
    weights = scores[:, :, None] * decay                 # (b,nc,h,i,j)
    y_intra = weights @ dtx.transpose(2, 3)              # (b,nc,h,i,p)

    # chunk end states: S[c] = sum_j B_j^T (decay_to_end_j * dtx_j)
    decay_to_end = torch.exp(cum[..., -1:] - cum)        # (b,nc,h,Q)
    wdtx = dtx * decay_to_end.transpose(2, 3)[..., None]  # (b,nc,Q,h,p)
    S = (Bc.transpose(-1, -2) @ wdtx.reshape(b, nc, Q, h * p)).reshape(
        b, nc, n, h, p).transpose(2, 3)                  # (b,nc,h,n,p)
    chunk_decay = torch.exp(cum[..., -1])                # (b,nc,h)

    carry = init_state if init_state is not None else \
        x.new_zeros((b, h, n, p))
    before = []
    for c in range(nc):                                  # state *before* c
        before.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + S[:, c]
    states_before = torch.stack(before, dim=1)           # (b,nc,h,n,p)

    # inter-chunk: C_i · state_before, scaled by exp(cum_i)
    inter = Cc @ states_before.transpose(2, 3).reshape(b, nc, n, h * p)
    y_inter = inter.reshape(b, nc, Q, h, p) * \
        torch.exp(cum).transpose(2, 3)[..., None]        # (b,nc,Q,h,p)
    y = (y_intra.transpose(2, 3) + y_inter).reshape(b, L, h, p)
    return y[:, :l], carry


def _ssm_inputs(params, xBC, dt_raw, cfg):
    """x (…, h, p), B, C (…, n) and dt (…, h) in float32, and A (h,)."""
    s = cfg.ssm
    d_inner, nheads, _ = _dims(cfg)
    x = xBC[..., :d_inner].reshape(
        xBC.shape[:-1] + (nheads, s.head_dim)).float()
    Bmat = xBC[..., d_inner:d_inner + s.state_dim].float()
    Cmat = xBC[..., d_inner + s.state_dim:].float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    return x, Bmat, Cmat, dt, A


def mamba2_forward(params, u, cfg, *, return_cache=False, init_cache=None):
    """u: (B, L, d_model) -> (B, L, d_model); with ``return_cache`` also
    {"conv": (B, W-1, conv_dim), "ssm": (B, h, n, p) float32}, which
    ``init_cache`` takes to continue the sequence."""
    d_inner = _dims(cfg)[0]
    B_, L, _ = u.shape
    z, xBC, dt_raw = _split_in(params, u, cfg)
    conv_state = None if init_cache is None else init_cache["conv"]
    xBC, new_conv = _causal_conv(params, xBC, cfg, conv_state)
    x, Bmat, Cmat, dt, A = _ssm_inputs(params, xBC, dt_raw, cfg)
    init_state = None if init_cache is None else init_cache["ssm"]
    y, final_state = ssd_chunked(x, dt, A, Bmat, Cmat, cfg.ssm.chunk_size,
                                 init_state)
    y = y + x * params["D"].float()[:, None]
    y = y.reshape(B_, L, d_inner).to(u.dtype)
    y = rmsnorm_gated(y, params["norm_w"], z, cfg.norm_eps)
    out = y @ params["w_out"]
    if return_cache:
        return out, {"conv": new_conv, "ssm": final_state}
    return out


def mamba2_decode(params, u, cfg, cache):
    """One-token step. u: (B,1,d); cache: {"conv": (B,W-1,conv_dim),
    "ssm": (B,h,n,p)}, both written in place with the new states and
    returned."""
    d_inner = _dims(cfg)[0]
    B_ = u.shape[0]
    z, xBC, dt_raw = _split_in(params, u, cfg)
    xBC, new_conv = _causal_conv(params, xBC, cfg, cache["conv"])
    x, Bmat, Cmat, dt, A = _ssm_inputs(params, xBC[:, 0], dt_raw[:, 0], cfg)
    dA = torch.exp(dt * A)                               # (B,h)
    dtx = x * dt[..., None]                              # (B,h,p)
    state = cache["ssm"] * dA[:, :, None, None] + \
        Bmat[:, None, :, None] * dtx[:, :, None, :]      # (B,h,n,p)
    y = (Cmat[:, None, None, :] @ state)[:, :, 0]        # (B,h,p)
    y = y + x * params["D"].float()[:, None]
    y = y.reshape(B_, 1, d_inner).to(u.dtype)
    y = rmsnorm_gated(y, params["norm_w"], z, cfg.norm_eps)
    # new_conv views a fresh concatenation: the slot is read already
    cache["conv"].copy_(new_conv)
    cache["ssm"].copy_(state)
    return y @ params["w_out"], cache


def mamba2_cache_spec(cfg, batch: int):
    """{"conv", "ssm"}: (shape, dtype) of one layer's decode state, the
    same for every max_len; the SSM state is float32 whatever
    ``cfg.dtype`` is."""
    s = cfg.ssm
    _, nheads, conv_dim = _dims(cfg)
    return {
        "conv": ((batch, s.conv_width - 1, conv_dim), cfg.torch_dtype()),
        "ssm": ((batch, nheads, s.state_dim, s.head_dim), torch.float32),
    }
