"""Carry the reference's weights across: ``params_from_numpy`` fills the
port's parameter tree from the reference's param pytree as numpy arrays
(``layers`` stacked on a leading L axis), so that both packages compute
the same function in the tests."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import transformer


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
