"""Mixture-of-Experts layer (Mixtral / Granite-MoE families) — a port of
``repro/models/moe.py``.

GShard-style capacity dispatch: each (token, k) pair takes the next
slot of its expert's queue of C slots, C = max(int(T K / E cf), 4);
pairs past the queue's end are dropped (their gate is 0). Two
dispatches compute the same function, as in the reference
(``cfg.moe_impl``):

* ``onehot``: the GShard einsums over a (T K, E, C) dispatch tensor;
* ``scatter``: index dispatch into the (E, C, d) expert buffer, an
  out-of-place ``index_put(..., accumulate=True)``, and a gather back.

Router auxiliary load-balance loss (Switch eq. 4):
  aux = E * sum_e( mean_tokens(p_e) * frac_tokens_routed_to_e ) * coef

Kept as the reference computes it: the router softmax in float32, the
top-k of the probabilities (sorted, as ``jax.lax.top_k``) renormalised,
the capacity expression in the reference's order (a reordered float
product can land on the other side of an integer), the queue positions
from a cumsum over the token-major (T K,) routing (run on an (E, T K)
one-hot, tokens innermost: on the card a cumsum down the outer axis of
the (T K, E) one-hot scans each expert's column in one thread, 47 ms of
a 4 x 4096 prefill's 78 ms a layer). The one-hots are
comparisons with an ``arange``, as ``jax.nn.one_hot`` builds them (no
range check of the indices, any dtype), and nothing is written in
place, so the layer runs under ``vmap(grad)``. The expert
products are batched matrix products (``torch.einsum``); the reference
runs no Pallas kernel here either.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense_init


def init_moe(gen, cfg, device=None):
    """The router (d, E) at scale 0.02 and the expert stacks (E, d, ff)
    / (E, ff, d), drawn from ``gen`` in the reference's order."""
    m = cfg.moe
    d = cfg.d_model
    dt = cfg.torch_param_dtype()

    def expert_stack(a, b):
        return torch.stack([dense_init(gen, a, b, dt, device=device)
                            for _ in range(m.num_experts)])

    return {
        "router": dense_init(gen, d, m.num_experts, dt, scale=0.02,
                             device=device),
        "w_gate": expert_stack(d, m.expert_ff),
        "w_up": expert_stack(d, m.expert_ff),
        "w_down": expert_stack(m.expert_ff, d),
    }


def one_hot(idx, n: int, dtype):
    """``idx[..., None] == arange(n)`` as ``dtype``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def capacity(tokens: int, cfg) -> int:
    """Slots per expert queue, the reference's expression (``moe.py:60``)."""
    m = cfg.moe
    return max(int(tokens * m.top_k / m.num_experts * m.capacity_factor), 4)


def route(params, xt, cfg):
    """Router of the (T, d) tokens: (probs (T, E), top_p (T, K), top_e
    (T, K)), top_p renormalised over the K picked."""
    logits = (xt @ params["router"]).float()                    # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.moe.top_k, dim=-1, sorted=True)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)      # renormalize
    return probs, top_p, top_e


def moe_forward(params, x, cfg):
    """x: (B, S, d) -> (y, aux_loss)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = m.num_experts, m.top_k
    xt = x.reshape(T, d)

    probs, top_p, top_e = route(params, xt, cfg)

    # ---- load balance auxiliary (Switch eq. 4) ----
    me = torch.mean(probs, dim=0)                               # (E,)
    routed = one_hot(top_e, E, torch.float32)                   # (T, K, E)
    ce = torch.mean(torch.sum(routed, dim=1), dim=0)            # frac per expert
    aux = E * torch.sum(me * ce) * m.router_aux_coef

    # ---- capacity-based dispatch ----
    C = capacity(T, cfg)
    # position of each (token, k) within its expert queue: the cumsum
    # over the token-major routing, laid out experts first so that it
    # runs along the innermost axis (integers: the same positions)
    flat_e = top_e.reshape(-1)                                  # (T*K,)
    onehot = (torch.arange(E, device=flat_e.device)[:, None]
              == flat_e).to(torch.int64)                        # (E, T*K)
    pos_in_e = torch.cumsum(onehot, dim=-1) * onehot - 1        # (E, T*K)
    pos = torch.sum(pos_in_e * onehot, dim=0)                   # (T*K,)
    keep = pos < C
    gate = top_p.reshape(-1) * keep                             # dropped -> 0

    if cfg.moe_impl == "scatter":
        # index dispatch: O(T*K*d) scatter/gather instead of the
        # O(T*E*C*d) one-hot einsums
        pos_c = torch.where(keep, pos, C - 1)
        x_rep = torch.repeat_interleave(xt, K, dim=0) \
            * keep[:, None].to(xt.dtype)
        expert_in = xt.new_zeros((E, C, d)).index_put(
            (flat_e, pos_c), x_rep, accumulate=True)
        h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, params["w_gate"]))
        h = h * torch.einsum("ecd,edf->ecf", expert_in, params["w_up"])
        expert_out = torch.einsum("ecf,efd->ecd", h, params["w_down"])
        picked = expert_out[flat_e, pos_c] * gate[:, None].to(xt.dtype)
        yt = picked.reshape(T, K, d).sum(dim=1)
        return yt.reshape(B, S, d), aux

    disp = (one_hot(flat_e, E, xt.dtype)[..., None]
            * one_hot(torch.where(keep, pos, 0), C, xt.dtype)[:, None, :]
            * keep[:, None, None].to(xt.dtype))                 # (T*K, E, C)
    disp_t = disp.reshape(T, K, E, C).sum(dim=1)                # (T, E, C)
    expert_in = torch.einsum("tec,td->ecd", disp_t, xt)         # (E, C, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, params["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, params["w_up"])
    expert_out = torch.einsum("ecf,efd->ecd", h, params["w_down"])  # (E, C, d)

    comb = (disp.reshape(T, K, E, C)
            * gate.reshape(T, K)[..., None, None].to(xt.dtype)).sum(dim=1)
    yt = torch.einsum("tec,ecd->td", comb, expert_out)          # (T, d)
    return yt.reshape(B, S, d), aux
