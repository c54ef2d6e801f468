"""Transformer stack — the dense family of ``repro/models/transformer.py``:
[attention + MLP] x L (qwen3, qwen1.5, chatglm3, and chameleon, whose
image tokens share the vocabulary).

Parameters are a tree of ``ParamTree`` modules that keeps the
reference's names and (in, out) layouts: ``params["layers"][i]["attn"]
["w_q"]`` is the reference's ``params["layers"]["attn"]["w_q"][i]``. The
layer stack is an ``nn.ModuleList`` walked by a Python loop where the
reference scans its stacked layers. The parameters do not require
gradients: training is a later slice.

The reference's other families (moe, ssm, hybrid, audio) and MLA raise
``NotImplementedError`` (ROADMAP Queue A item 11). ``remat`` changes
nothing at inference.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from . import attention as attn
from .layers import dense_init, embed_init, init_mlp, mlp, rmsnorm

NOT_PORTED = attn.NOT_PORTED


class ParamTree(nn.Module):
    """One node of the parameter tree: the reference's dict of arrays as
    a module. Leaves are parameters, dicts are subtrees, lists become an
    ``nn.ModuleList``; items are read by the reference's names
    (``tree["w_q"]``)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, list):
                self.add_module(name, nn.ModuleList(
                    ParamTree(item) for item in value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def check_family(cfg) -> None:
    """The families the port has: dense GQA (dense, vlm)."""
    if cfg.arch_type not in ("dense", "vlm") or cfg.moe is not None \
            or cfg.ssm is not None or cfg.is_enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: arch_type {cfg.arch_type!r} is not ported yet "
            f"({NOT_PORTED}); the port has the dense GQA family")
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA attention is not ported yet ({NOT_PORTED})")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_dense_layer(gen, cfg, device):
    dt = cfg.torch_param_dtype()
    return {
        "attn": attn.init_attention(gen, cfg, device=device),
        "norm1": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "norm2": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dt,
                        device=device),
    }


def init_params(gen: Optional[torch.Generator], cfg, device=None) -> ParamTree:
    """The reference's distributions drawn from ``gen`` on ``device``
    (``gen``'s device by default); ``gen=None`` with ``device="meta"``
    gives the tree's shapes without data."""
    check_family(cfg)
    device = device if device is not None else gen.device
    dt = cfg.torch_param_dtype()
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt,
                            device=device),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                       device=device)
    params["layers"] = [_init_dense_layer(gen, cfg, device)
                        for _ in range(cfg.num_layers)]
    return ParamTree(params)


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _dense_layer_fwd(lp, x, cfg, positions):
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    a = attn.gqa_forward(lp["attn"], h, cfg, positions,
                         window=cfg.sliding_window)
    x = x + a
    h = rmsnorm(x, lp["norm2"], cfg.norm_eps)
    return x + mlp(lp["mlp"], h, cfg.act)


def forward(params, tokens, cfg, *, enc_frames=None, logits_mode="all"):
    """tokens: (B, S) integers -> (logits (B, S, V), aux).

    logits_mode="last": project only the final position (serving prefill
    needs one next-token distribution, not S of them). ``aux`` is the
    reference's auxiliary loss, zero for the dense family."""
    check_family(cfg)
    if enc_frames is not None:
        raise NotImplementedError(
            f"enc_frames belong to the enc-dec family ({NOT_PORTED})")
    B, S = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(S, device=x.device).expand(B, S)
    for lp in params["layers"]:
        x = _dense_layer_fwd(lp, x, cfg, positions)
    if logits_mode == "last":
        x = x[:, -1:]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), torch.zeros((), device=x.device)


def _logits(params, x, cfg):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# decode (one token against a pre-filled cache)
# ---------------------------------------------------------------------------

def init_cache_specs(cfg, batch: int, max_len: int):
    """{"layers": {"k", "v"}}: (shape, dtype) of the decode cache, the
    layers stacked on a leading axis as in the reference."""
    check_family(cfg)
    return {"layers": {name: ((cfg.num_layers,) + shape, dt) for name,
                       (shape, dt) in attn.gqa_cache_spec(
                           cfg, batch, max_len).items()}}


def init_cache(cfg, batch: int, max_len: int, device=None):
    specs = init_cache_specs(cfg, batch, max_len)
    return {"layers": {name: torch.zeros(shape, dtype=dt, device=device)
                       for name, (shape, dt) in specs["layers"].items()}}


def decode_step(params, token, cache, pos, cfg):
    """token: (B, 1) integers; pos: the current cache fill. Returns
    (logits (B, 1, V), cache), the cache updated in place."""
    check_family(cfg)
    x = params["embed"][token]
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(params["layers"]):
        h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
        a, _ = attn.gqa_decode(lp["attn"], h, cfg, {"k": ck[i], "v": cv[i]},
                               pos)
        y = x + a
        x = y + mlp(lp["mlp"], rmsnorm(y, lp["norm2"], cfg.norm_eps),
                    cfg.act)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), cache
