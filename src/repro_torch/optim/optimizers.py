"""Minimal pure optimizer library: SGD(+momentum, Nesterov) and AdamW,
a port of ``repro/optim/optimizers.py``. Used by the synchronous
baseline trainer the paper's method is compared against, and by
examples.

The API mirrors optax, as the reference's does: ``opt.init(params) ->
state``; ``opt.update(grads, state, params) -> (updates, state)``; apply
with ``apply_updates``. Every function is plain tensor arithmetic over
a params tree (nested dicts and lists of tensors, walked in JAX's leaf
order by ``core.tree``) and returns new tensors, writing none in place.
The step counter is a host integer, so a schedule reads it without
waiting for the device; AdamW's bias corrections are taken in float32,
as the reference takes them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.tree import tree_flatten, tree_map, tree_unflatten


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of
    ``rest`` (trees of one structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def apply_updates(params, updates):
    return _map(lambda p, u: p + u.to(p.dtype), params, updates)


def _lr(lr, step: int):
    return lr(step) if callable(lr) else lr


def sgd(lr, momentum: float = 0.0, nesterov: bool = False) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"step": 0}
        return {"step": 0, "mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        step = int(state["step"]) + 1
        lr_t = _lr(lr, step)
        if momentum == 0.0:
            return tree_map(lambda g: -lr_t * g, grads), {"step": step}
        mu = _map(lambda m, g: momentum * m + g, state["mu"], grads)
        if nesterov:
            upd = _map(lambda m, g: -lr_t * (momentum * m + g), mu, grads)
        else:
            upd = tree_map(lambda m: -lr_t * m, mu)
        return upd, {"step": step, "mu": mu}

    return Optimizer(init, update)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"step": 0, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params):
        step = int(state["step"]) + 1
        lr_t = _lr(lr, step)
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                 state["m"], grads)
        v = _map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                 state["v"], grads)
        bc1 = float(1 - np.float32(b1) ** np.float32(step))
        bc2 = float(1 - np.float32(b2) ** np.float32(step))

        def upd(m_, v_, p):
            u = -lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                u = u - lr_t * weight_decay * p.float()
            return u
        return _map(upd, m, v, params), {"step": step, "m": m, "v": v}

    return Optimizer(init, update)
