"""Transformer stack — the families of ``repro/models/transformer.py``:

  dense  — [attention + MLP] x L  (qwen3, qwen1.5, chatglm3, chameleon,
                                   whose image tokens share the
                                   vocabulary, and minicpm3, whose
                                   attention is MLA)
  moe    — [attention + MoE] x L  (mixtral, with its sliding window;
                                   granite-moe)
  ssm    — [mamba2] x L           (mamba2-370m)
  hybrid — groups of k mamba2 layers, a *shared* attention block
           (one dense layer's weights, not stacked) applied after each
           group, then the rest of the layers (zamba2)
  audio  — an encoder of bidirectional dense layers over frame
           embeddings (the conv frontend stubbed, as in the reference),
           then a decoder whose layers add cross-attention to the
           encoder's output (whisper)

A MoE layer returns its output and its auxiliary loss (the router's
load-balance term); ``forward`` sums the layers' in layer order, as the
reference's scan carries it (zero for the other families), and
``decode_step`` drops it.

Two parameter trees, one forward:

* inference holds a tree of ``ParamTree`` modules that keeps the
  reference's names and (in, out) layouts: ``params["layers"][i]["attn"]
  ["w_q"]`` is the reference's ``params["layers"]["attn"]["w_q"][i]``,
  each layer stack (``layers``, and the encoder's ``enc_layers``) an
  ``nn.ModuleList``; its parameters do not require gradients;
* training differentiates the reference's own tree, a nested dict whose
  ``layers`` and ``enc_layers`` leaves are stacked on a leading axis
  (``weights.stacked_params``; the hybrid's ``shared_attn`` is not).
  ``forward`` takes each stacked leaf apart once with ``torch.unbind``
  (its backward is one ``stack``; indexing ``leaf[i]`` per layer would
  make each layer's backward write a zeroed (L, ...) tensor) and walks
  the layers with the same Python loop where the reference scans them.
  The pass writes in place only into tensors it made (MLA's scores),
  in steps autograd differentiates, and reads no value on the host, so
  it runs under ``torch.func.grad`` and ``vmap``.

The decode cache keeps the reference's layout: ``{"layers": {"k",
"v"}}`` for the GQA families, ``{"layers": {"c_kv", "k_rope"}}`` (the
latent) for MLA, ``{"layers": {"conv", "ssm"}}`` (a constant-size state
per layer) for ssm; the hybrid adds ``{"shared_attn": {"k", "v"}}``
stacked over the shared block's applications, and enc-dec the
top-level ``cross_k`` and ``cross_v`` of (L, B, T_enc, nkv, hd), filled
once from the encoder (``Engine``) and read by every decode step.
``decode_step`` updates the cache in place.

``remat`` changes nothing at inference (the ``ParamTree``); on the
stacked tree it checkpoints each layer of every loop the reference
scans under ``jax.checkpoint`` (the dense / MoE loop, the SSM loop, the
hybrid's SSM layers, the enc-dec encoder and decoder): the layer runs
in a :class:`_Remat` function that saves only its inputs (the carry,
the layer's parameter leaves and what the layer reads beside them) and
recomputes the layer under ``torch.func.vjp`` in the backward.
``torch.utils.checkpoint`` is not used: ``torch.func.grad`` refuses
its saved-tensor hooks. The hybrid's shared block is not checkpointed,
as the reference's is not.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..core.tree import tree_flatten, tree_unflatten

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import dense_init, embed_init, init_mlp, mlp, rmsnorm


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


FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def check_family(cfg) -> None:
    """The reference's arch types: dense (GQA or MLA), vlm, moe, ssm,
    hybrid and audio (enc-dec: ``encoder_layers`` > 0)."""
    if cfg.arch_type not in FAMILIES:
        raise ValueError(f"{cfg.name}: arch_type {cfg.arch_type!r} is not "
                         f"one of {FAMILIES}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_dense_layer(gen, cfg, device, *, cross: bool = False):
    dt = cfg.torch_param_dtype()
    p = {
        "attn": attn.init_attention(gen, cfg, device=device),
        "norm1": torch.ones((cfg.d_model,), dtype=dt, device=device),
        "norm2": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if cfg.moe is not None:
        p["moe"] = moe_mod.init_moe(gen, cfg, device)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, dt,
                            device=device)
    if cross:
        p["cross"] = attn.init_attention(gen, cfg, cross=True, device=device)
        p["norm_cross"] = torch.ones((cfg.d_model,), dtype=dt, device=device)
    return p


def _init_ssm_layer(gen, cfg, device):
    return {
        "mamba": ssm_mod.init_mamba2(gen, cfg, device),
        "norm1": torch.ones((cfg.d_model,), dtype=cfg.torch_param_dtype(),
                            device=device),
    }


def init_layer(gen, cfg, device):
    """One layer of ``params["layers"]``: an SSM layer for the ssm and
    hybrid families, else a dense (attention + MLP or MoE) layer, with
    cross-attention in an enc-dec decoder."""
    if cfg.arch_type in ("ssm", "hybrid"):
        return _init_ssm_layer(gen, cfg, device)
    return _init_dense_layer(gen, cfg, device, cross=cfg.is_enc_dec)


def init_encoder_layer(gen, cfg, device):
    """One layer of an enc-dec model's ``params["enc_layers"]``."""
    return _init_dense_layer(gen, cfg, device)


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
    params["layers"] = [init_layer(gen, cfg, device)
                        for _ in range(cfg.num_layers)]
    if cfg.arch_type == "hybrid":
        params["shared_attn"] = _init_dense_layer(gen, cfg, device)
    elif cfg.is_enc_dec:
        params["enc_layers"] = [init_encoder_layer(gen, cfg, device)
                                for _ in range(cfg.encoder_layers)]
        params["enc_norm"] = torch.ones((cfg.d_model,), dtype=dt,
                                        device=device)
    return ParamTree(params)


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _ffn(lp, h, cfg):
    """The layer's MoE or MLP on ``h``: (y, aux), aux None for an MLP
    (no zero is made per layer)."""
    if cfg.moe is not None:
        return moe_mod.moe_forward(lp["moe"], h, cfg)
    return mlp(lp["mlp"], h, cfg.act), None


def _cross(lp, x, enc_kv, cfg):
    """The decoder layer's cross-attention on ``x``, added to it."""
    return x + attn.cross_attn_forward(
        lp["cross"], rmsnorm(x, lp["norm_cross"], cfg.norm_eps), enc_kv, cfg)


def _dense_layer_fwd(lp, x, cfg, positions, *, causal=True, enc_kv=None):
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    if cfg.mla is not None:
        a = attn.mla_forward(lp["attn"], h, cfg, positions)
    else:
        a = attn.gqa_forward(lp["attn"], h, cfg, positions,
                             window=cfg.sliding_window, causal=causal)
    x = x + a
    if enc_kv is not None:
        x = _cross(lp, x, enc_kv, cfg)
    y, aux = _ffn(lp, rmsnorm(x, lp["norm2"], cfg.norm_eps), cfg)
    return x + y, aux


def _ssm_layer_fwd(lp, x, cfg):
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    return x + ssm_mod.mamba2_forward(lp["mamba"], h, cfg)


def _differentiated_again(saved) -> bool:
    """Whether the backward being run is itself differentiated: a
    backward with ``create_graph=True`` outside ``torch.func``, a second
    ``grad`` / ``jvp`` transform around the one running, or autograd
    recording the tensors under the transforms (a leaf that requires
    grad). A single ``torch.func.grad`` runs its backward with grad
    enabled and is not."""
    from torch._C._functorch import (TransformType, get_unwrapped,
                                     is_batchedtensor, is_gradtrackingtensor)
    from torch._functorch.pyfunctorch import \
        retrieve_all_functorch_interpreters
    levels = [i.key() for i in retrieve_all_functorch_interpreters()]
    if not levels:
        return torch.is_grad_enabled()
    if sum(k in (TransformType.Grad, TransformType.Jvp)
           for k in levels) > 1:
        return True
    for t in saved:
        while is_gradtrackingtensor(t) or is_batchedtensor(t):
            t = get_unwrapped(t)
        if t.requires_grad:
            return True
    return False


class _Remat(torch.autograd.Function):
    """``fn(*args)`` (a tuple of tensors) with only ``args`` saved: the
    backward runs ``fn`` again under ``torch.func.vjp`` and pulls the
    cotangents back to every floating-point argument, unrecorded: a
    second derivative through a checkpointed layer raises
    (:func:`_differentiated_again`) rather than miss the layer's term.
    Every tensor the layer reads must be in ``args`` (a tensor closed
    over would get no gradient); ``generate_vmap_rule`` lets it run
    under ``vmap``."""
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *cotangents):
        args = ctx.saved_tensors
        if _differentiated_again(args):
            raise RuntimeError(
                "remat=True: a checkpointed layer's backward is not "
                "differentiable (its pull is taken unrecorded); take "
                "second derivatives with remat=False")
        diff = [i for i, a in enumerate(args) if a.is_floating_point()]

        def of_diff(*d):
            full = list(args)
            for i, t in zip(diff, d):
                full[i] = t
            return ctx.fn(*full)

        _, pull = torch.func.vjp(of_diff, *(args[i] for i in diff))
        # not recorded for a second derivative: torch.func.grad takes
        # its gradient with create_graph=True, which would keep every
        # tensor of the recompute and its backward alive to the end
        with torch.no_grad():
            pulled = pull(tuple(cotangents))
        grads = [None] * len(args)
        for i, g in zip(diff, pulled):
            grads[i] = g
        return (None, *grads)


def _layer_call(cfg, layer_fn: Callable, lp, *inputs):
    """``layer_fn(lp, *inputs)`` (a tensor, or a tuple whose None entries
    stay None), checkpointed under ``cfg.remat`` when ``lp`` is a layer
    of the stacked tree (a dict of tensors), as the reference's
    ``_scan_layers`` checkpoints its scan body."""
    if not (cfg.remat and isinstance(lp, dict)):
        return layer_fn(lp, *inputs)
    leaves, treedef = tree_flatten(lp)
    n = len(inputs)
    kept = []                          # which outputs are tensors

    def flat(*args):
        out = layer_fn(tree_unflatten(treedef, args[n:]), *args[:n])
        outs = out if isinstance(out, tuple) else (out,)
        kept[:] = [o is not None for o in outs]
        return tuple(o for o in outs if o is not None)

    outs = iter(_Remat.apply(flat, *inputs, *leaves))
    full = [next(outs) if k else None for k in kept]
    return tuple(full) if len(full) > 1 else full[0]


def _dense_layer(lp, x, positions, cfg, causal=True):
    return _layer_call(cfg, lambda p, h, pos: _dense_layer_fwd(
        p, h, cfg, pos, causal=causal), lp, x, positions)


def _ssm_layer(lp, x, cfg):
    return _layer_call(cfg, lambda p, h: _ssm_layer_fwd(p, h, cfg), lp, x)


def _decoder_layer(lp, x, positions, enc, cfg):
    """An enc-dec decoder layer: its cross K/V from ``enc`` inside the
    layer, as the reference's scan body computes them."""
    return _layer_call(cfg, lambda p, h, pos, e: _dense_layer_fwd(
        p, h, cfg, pos, enc_kv=attn.encode_cross_kv(p["cross"], e, cfg)),
        lp, x, positions, enc)


def _hybrid_groups(cfg):
    """(k, groups): the shared block follows each of the ``groups`` runs
    of k SSM layers; the layers past the last run follow no block."""
    k = max(cfg.hybrid_attn_every, 1)
    return k, cfg.num_layers // k


def _hybrid_forward(params, layers, x, cfg, positions):
    k, n_groups = _hybrid_groups(cfg)
    for g in range(n_groups):
        for lp in layers[g * k:(g + 1) * k]:
            x = _ssm_layer(lp, x, cfg)
        x, _ = _dense_layer_fwd(params["shared_attn"], x, cfg, positions)
    for lp in layers[n_groups * k:]:
        x = _ssm_layer(lp, x, cfg)
    return x


def unbind_layers(stacked: Dict[str, Any]):
    """The per-layer trees of a stacked layer tree, each leaf taken apart
    once along its leading L axis (views of the stacked leaves)."""
    parts = {name: unbind_layers(value) if isinstance(value, dict)
             else torch.unbind(value, 0) for name, value in stacked.items()}
    num_layers = len(next(iter(parts.values())))
    return [{name: layers[i] for name, layers in parts.items()}
            for i in range(num_layers)]


def _layer_list(params, name: str, cfg):
    """``params[name]``'s layers: a ``ParamTree``'s modules, or the
    stacked tree's leaves unbound once."""
    layers = params[name]
    if isinstance(layers, dict):
        return unbind_layers(layers)
    return layers


def check_enc_frames(cfg, enc_frames) -> None:
    if not cfg.is_enc_dec and enc_frames is not None:
        raise ValueError(f"{cfg.name}: enc_frames are the encoder's input; "
                         f"this arch has no encoder (encoder_layers=0)")


def encode(params, frames, cfg):
    """The enc-dec encoder: its layers over ``frames`` (B, T_enc, d) at
    positions 0..T_enc-1, bidirectional (under ``attn_impl="flash"``, B7
    without the causal mask), then ``enc_norm``."""
    B, T = frames.shape[:2]
    positions = torch.arange(T, device=frames.device).expand(B, T)
    x = frames
    for lp in _layer_list(params, "enc_layers", cfg):
        x, _ = _dense_layer(lp, x, positions, cfg, causal=False)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def forward(params, tokens, cfg, *, enc_frames=None, logits_mode="all"):
    """tokens: (B, S) integers -> (logits (B, S, V), aux), on a
    ``ParamTree`` or on the stacked tree (``params["layers"]`` a dict of
    (L, ...) leaves). ``enc_frames``: (B, T_enc, d_model) frame
    embeddings, the encoder's input, for an enc-dec arch only (cast to
    the embedding's dtype).

    logits_mode="last": project only the final position (serving prefill
    needs one next-token distribution, not S of them). ``aux`` is the
    reference's auxiliary loss: the layers' summed in layer order (the
    MoE router's load-balance term), zero for the other families."""
    check_family(cfg)
    check_enc_frames(cfg, enc_frames)
    if cfg.is_enc_dec and enc_frames is None:
        raise ValueError(f"{cfg.name}: an enc-dec forward needs enc_frames")
    layers = _layer_list(params, "layers", cfg)
    B, S = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux_total = torch.zeros((), device=x.device)
    if cfg.arch_type == "ssm":
        for lp in layers:
            x = _ssm_layer(lp, x, cfg)
    elif cfg.arch_type == "hybrid":
        x = _hybrid_forward(params, layers, x, cfg, positions)
    elif cfg.is_enc_dec:
        enc = encode(params, enc_frames.to(x.dtype), cfg)
        for lp in layers:
            x, _ = _decoder_layer(lp, x, positions, enc, cfg)
    else:
        for lp in layers:
            x, aux = _dense_layer(lp, x, positions, cfg)
            if aux is not None:
                aux_total = aux_total + aux
    if logits_mode == "last":
        x = x[:, -1:]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), aux_total


def _logits(params, x, cfg):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


# ---------------------------------------------------------------------------
# decode (one token against a pre-filled cache)
# ---------------------------------------------------------------------------

def init_cache_specs(cfg, batch: int, max_len: int):
    """(shape, dtype) of each tensor of the decode cache, the layers
    stacked on a leading axis as in the reference: {"layers": {"k",
    "v"}}, {"c_kv", "k_rope"} for MLA, or {"conv", "ssm"} for the SSM
    layers; the hybrid adds {"shared_attn": {"k", "v"}}, one cache per
    application of the shared block; enc-dec adds the top-level
    "cross_k" and "cross_v", (L, batch, T_enc, nkv, hd) each."""
    check_family(cfg)

    def stack(spec, n):
        return {name: ((n,) + shape, dt) for name, (shape, dt) in
                spec.items()}

    L = cfg.num_layers
    if cfg.arch_type == "ssm":
        return {"layers": stack(ssm_mod.mamba2_cache_spec(cfg, batch), L)}
    if cfg.arch_type == "hybrid":
        return {"layers": stack(ssm_mod.mamba2_cache_spec(cfg, batch), L),
                "shared_attn": stack(attn.gqa_cache_spec(cfg, batch, max_len),
                                     _hybrid_groups(cfg)[1])}
    if cfg.mla is not None:
        return {"layers": stack(attn.mla_cache_spec(cfg, batch, max_len), L)}
    cache = {"layers": stack(attn.gqa_cache_spec(cfg, batch, max_len), L)}
    if cfg.is_enc_dec:
        shape = (L, batch, cfg.encoder_seq_len, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        cache["cross_k"] = cache["cross_v"] = (shape, cfg.torch_dtype())
    return cache


def init_cache(cfg, batch: int, max_len: int, device=None):
    def zeros(spec):
        if isinstance(spec, dict):
            return {name: zeros(s) for name, s in spec.items()}
        shape, dt = spec
        return torch.zeros(shape, dtype=dt, device=device)

    return zeros(init_cache_specs(cfg, batch, max_len))


def _slot(cache, i):
    """Layer (or application) i's views of a stacked cache part."""
    return {name: t[i] for name, t in cache.items()}


def _ssm_layer_decode(lp, x, cfg, cache):
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    y, _ = ssm_mod.mamba2_decode(lp["mamba"], h, cfg, cache)
    return x + y


def _dense_layer_decode(lp, x, cfg, cache, pos, enc_kv=None):
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    decode = attn.mla_decode if cfg.mla is not None else attn.gqa_decode
    a, _ = decode(lp["attn"], h, cfg, cache, pos)
    y = x + a
    if enc_kv is not None:
        y = _cross(lp, y, enc_kv, cfg)
    z, _ = _ffn(lp, rmsnorm(y, lp["norm2"], cfg.norm_eps), cfg)
    return y + z


def decode_step(params, token, cache, pos, cfg):
    """token: (B, 1) integers; pos: the current cache fill. Returns
    (logits (B, 1, V), cache), the cache updated in place."""
    check_family(cfg)
    x = params["embed"][token]
    for i, lp in enumerate(params["layers"]):
        if cfg.arch_type not in ("ssm", "hybrid"):
            enc_kv = (cache["cross_k"][i], cache["cross_v"][i]) \
                if cfg.is_enc_dec else None
            x = _dense_layer_decode(lp, x, cfg, _slot(cache["layers"], i),
                                    pos, enc_kv)
            continue
        x = _ssm_layer_decode(lp, x, cfg, _slot(cache["layers"], i))
        k = max(cfg.hybrid_attn_every, 1)
        if cfg.arch_type == "hybrid" and (i + 1) % k == 0:
            x = _dense_layer_decode(params["shared_attn"], x, cfg,
                                    _slot(cache["shared_attn"], i // k), pos)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x, cfg), cache
