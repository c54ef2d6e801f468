"""The reference's parameter layout, both ways.

Two trees hold one model's weights: the port's inference tree
(``ParamTree``, one module per layer) and the reference's nested dict
with ``layers`` (and an enc-dec model's ``enc_layers``) stacked on a
leading axis, the tree training differentiates and pytree-mode
consensus packs (its leaf order and block assignment are the
reference's).

* ``params_from_numpy`` fills a ``ParamTree`` from the reference's
  param pytree as numpy arrays; ``stacked_from_numpy`` carries the same
  arrays into the stacked dict. With either, both packages compute the
  same function in the tests.
* ``stacked_params`` draws the port's weights straight into the
  stacked dict.
* ``params_from_stacked`` views a stacked dict (a trained state) as a
  ``ParamTree`` for serving, without a copy."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, seeded_generator
from . import transformer
from .layers import dense_init, embed_init


def _tensor(value) -> torch.Tensor:
    """A CPU tensor of a numpy array, dtype kept: numpy's ``bfloat16``
    (ml_dtypes, as the reference's bf16 arrays convert) through its raw
    16-bit words."""
    a = np.asarray(value)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def stack_depths(cfg) -> Dict[str, int]:
    """The stacked subtrees of ``cfg``'s tree and their depths: ``layers``,
    and an enc-dec model's ``enc_layers``."""
    depths = {"layers": cfg.num_layers}
    if cfg.is_enc_dec:
        depths["enc_layers"] = cfg.encoder_layers
    return depths


def params_from_numpy(cfg, tree: Dict[str, Any],
                      device: DeviceLike = None) -> transformer.ParamTree:
    """The port's ``ParamTree`` holding the reference tree's arrays on
    ``device``; every name and shape must match the port's tree for
    ``cfg`` (``load_state_dict(strict=True)``)."""
    dev = resolve_device(device)
    depths = stack_depths(cfg)
    state = {}
    for name, value in _flatten(tree):
        value = np.asarray(value)
        stack, _, rest = name.partition(".")
        if stack in depths and rest:
            if value.shape[0] != depths[stack]:
                raise ValueError(f"{name}: {value.shape[0]} stacked layers, "
                                 f"the config has {depths[stack]}")
            for i in range(depths[stack]):
                state[f"{stack}.{i}.{rest}"] = torch.tensor(value[i])
        else:
            state[name] = torch.tensor(value)
    params = transformer.init_params(None, cfg, "meta")
    params.load_state_dict({k: v.to(dev) for k, v in state.items()},
                           strict=True, assign=True)
    params.requires_grad_(False)
    return params


def _stack_into(dst: Dict[str, Any], layer: Dict[str, Any], i: int) -> None:
    for name, value in layer.items():
        if isinstance(value, dict):
            _stack_into(dst[name], value, i)
        else:
            dst[name][i].copy_(value)


def _stacked_like(layer: Dict[str, Any], num_layers: int):
    return {name: _stacked_like(value, num_layers) if isinstance(value, dict)
            else value.new_empty((num_layers,) + tuple(value.shape))
            for name, value in layer.items()}


def _stacked_layers(make, num_layers: int) -> Dict[str, Any]:
    """``num_layers`` layers drawn by ``make()`` in turn, written into
    leaves stacked on a leading axis (one layer beside the stack at a
    time). On the meta device, where there is nothing to draw, one
    layer gives the stack its shapes."""
    stack: Dict[str, Any] = {}
    for i in range(num_layers):
        layer = make()
        if i == 0:
            stack = _stacked_like(layer, num_layers)
            if _first_leaf(layer).device.type == "meta":
                return stack
        _stack_into(stack, layer, i)
    return stack


def _first_leaf(tree):
    value = next(iter(tree.values()))
    return _first_leaf(value) if isinstance(value, dict) else value


def stacked_params(cfg, seed: int = 0,
                   device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's param pytree for ``cfg`` as a nested dict of
    tensors on ``device`` (``"meta"`` for shapes alone): ``embed``,
    ``final_norm`` (``lm_head`` if untied), ``layers`` with every leaf
    stacked on a leading L axis, for the hybrid family the unstacked
    ``shared_attn`` layer, and for enc-dec ``enc_layers`` (stacked on
    ``encoder_layers``) and ``enc_norm``. The values are
    ``Model.init(seed, device)``'s, drawn in the same order."""
    transformer.check_family(cfg)
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else seeded_generator(dev, seed)
    dt = cfg.torch_param_dtype()
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt, device=dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                       device=dev)
    params["layers"] = _stacked_layers(
        lambda: transformer.init_layer(gen, cfg, dev), cfg.num_layers)
    if cfg.arch_type == "hybrid":
        params["shared_attn"] = transformer._init_dense_layer(gen, cfg, dev)
    elif cfg.is_enc_dec:
        params["enc_layers"] = _stacked_layers(
            lambda: transformer.init_encoder_layer(gen, cfg, dev),
            cfg.encoder_layers)
        params["enc_norm"] = torch.ones((cfg.d_model,), dtype=dt, device=dev)
    return params


def _fill_like(like: Dict[str, Any], tree: Dict[str, Any], dev,
               prefix: str = "") -> Dict[str, Any]:
    """``tree``'s arrays as tensors on ``dev``, checked name by name and
    shape by shape against the meta tree ``like``."""
    if set(like) != set(tree):
        raise ValueError(f"{prefix or 'the tree'}: names {sorted(tree)}, "
                         f"the config's stacked tree has {sorted(like)}")
    out = {}
    for name, spec in like.items():
        if isinstance(spec, dict):
            out[name] = _fill_like(spec, tree[name], dev, f"{prefix}{name}.")
            continue
        t = _tensor(tree[name])
        if tuple(t.shape) != tuple(spec.shape):
            raise ValueError(f"{prefix}{name}: shape {tuple(t.shape)}, the "
                             f"config's is {tuple(spec.shape)}")
        out[name] = t.to(dev)
    return out


def stacked_from_numpy(cfg, tree: Dict[str, Any],
                       device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's param pytree (numpy arrays, ``layers`` stacked on
    a leading L axis) as the port's stacked dict of tensors on
    ``device``, dtypes kept; names and shapes must be those of
    ``stacked_params(cfg)``."""
    return _fill_like(stacked_params(cfg, device="meta"), tree,
                      resolve_device(device))


def params_from_stacked(cfg, stacked: Dict[str, Any]
                        ) -> transformer.ParamTree:
    """The ``ParamTree`` whose parameters are views of the stacked tree's
    leaves (layer i's are the leaves' slices at i): no weight is copied,
    so the tree serves what the stacked tree holds."""
    transformer.check_family(cfg)
    tree = dict(stacked)
    for name, depth in stack_depths(cfg).items():
        tree[name] = transformer.unbind_layers(stacked[name])
        if len(tree[name]) != depth:
            raise ValueError(f"{name}: {len(tree[name])} stacked layers, "
                             f"the config has {depth}")
    return transformer.ParamTree(tree)
