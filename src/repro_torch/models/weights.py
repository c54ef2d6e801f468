"""The reference's parameter layout, both ways.

``params_from_numpy`` fills the port's parameter tree (``ParamTree``,
one module per layer) from the reference's param pytree as numpy arrays
(``layers`` stacked on a leading L axis), so that both packages compute
the same function in the tests. ``stacked_params`` goes the other way:
it draws the port's weights straight into the reference's nested dict
with stacked layers, the tree pytree-mode consensus packs, so its leaf
order and block assignment are the reference's."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, seeded_generator
from . import transformer
from .layers import dense_init, embed_init


def _flatten(tree: Dict[str, Any], prefix: str = ""):
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def params_from_numpy(cfg, tree: Dict[str, Any],
                      device: DeviceLike = None) -> transformer.ParamTree:
    """The port's ``ParamTree`` holding the reference tree's arrays on
    ``device``; every name and shape must match the port's tree for
    ``cfg`` (``load_state_dict(strict=True)``)."""
    dev = resolve_device(device)
    state = {}
    for name, value in _flatten(tree):
        value = np.asarray(value)
        if name.startswith("layers."):
            if value.shape[0] != cfg.num_layers:
                raise ValueError(f"{name}: {value.shape[0]} stacked layers, "
                                 f"the config has {cfg.num_layers}")
            rest = name[len("layers."):]
            for i in range(cfg.num_layers):
                state[f"layers.{i}.{rest}"] = torch.tensor(value[i])
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


def stacked_params(cfg, seed: int = 0,
                   device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's param pytree for ``cfg`` as a nested dict of
    tensors on ``device`` (``"meta"`` for shapes alone): ``embed``,
    ``final_norm`` (``lm_head`` if untied), and ``layers`` with every
    leaf stacked on a leading L axis. The values are ``Model.init(seed,
    device)``'s, drawn in the same order and written layer by layer into
    the stacked leaves (one layer beside the stack at a time)."""
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
    stack: Dict[str, Any] = {}
    for i in range(cfg.num_layers):
        layer = transformer._init_dense_layer(gen, cfg, dev)
        if i == 0:
            stack = _stacked_like(layer, cfg.num_layers)
        _stack_into(stack, layer, i)
    params["layers"] = stack
    return params
