"""Placement rules: map params / ADMM state / inputs / caches to placement
specs (:class:`~repro_torch.launch.mesh.P`) on the production mesh.

Port of ``repro/launch/shardings.py``, decision for decision, on the
port's trees (the stacked params tree of ``Model.param_specs``, the
trainer's ``ADMMTrainState``, the decode cache of ``Model.cache_specs``;
leaves are tensors, on the meta device for shapes alone). Key paths are
``core.tree``'s, which carry ``.key`` as jax's do.

Parameter rule (tensor parallelism over the ``model`` axis):
  * stacked layer leaves carry a leading (num_layers,) scan axis — skipped;
  * shard the dim divisible by the model-axis size, preferring the
    largest (ties -> the later dim); replicate if nothing divides (tiny
    norms / biases).

ADMM state rule:
  * the BASE layout (z_hist ring replicated, y / w_cache worker axis
    over the data axes) is ``core.sharded``'s — the same base specs the
    SPMD epoch's tiles follow; this module only *overlays* the
    tensor-parallel ``model``-axis param dims on top of it.

Input rule:
  * worker-batched train inputs (N, b, ...): N over the data axes;
  * flat batch (B, ...): B over data axes if divisible, else replicated;
  * decode caches: batch over data axes if divisible; the largest
    remaining dim over ``model`` (a K/V cache's *sequence*).

The port has no tensor parallelism: its SPMD epoch splits the packed
block table, not a weight's dims, and it serves a whole model per card.
These rules place the reference's programs; ``launch/dryrun.py`` charges
their per-device argument bytes (``spec_argument_bytes``) beside the
bytes the port's own programs hold. ``local_shard`` (``launch/mesh.py``)
is the port's ``named`` / ``NamedSharding``: a rank's slice of a full
tensor under a spec.
"""
from __future__ import annotations

from typing import Any

from ..core.sharded import ring_spec, worker_bundle_spec
from ..core.tree import tree_map, tree_map_with_path
from ..training.train_state import ADMMTrainState
from .mesh import (P, data_axes, local_shard, model_axis_size, num_workers,
                   shard_shape)

__all__ = ["P", "param_specs", "admm_state_specs", "batch_specs",
           "cache_specs_tree", "is_spec", "local_shard", "shard_shape"]


def is_spec(x) -> bool:
    """A spec tree's leaf test (``core.tree``'s flattener would open a
    spec, which is a tuple): ``tree_leaves(specs, is_leaf=is_spec)``."""
    return isinstance(x, P)


def _shard_param_dims(shape, model_size: int, skip_leading: int = 0):
    spec = [None] * len(shape)
    # prefer the largest dim (ties -> later dim); require divisibility
    best, best_size = None, 0
    for i in range(skip_leading, len(shape)):
        if shape[i] % model_size == 0 and shape[i] >= model_size:
            if shape[i] >= best_size:
                best, best_size = i, shape[i]
    if best is not None:
        spec[best] = "model"
    return spec


def _keys(path):
    return [getattr(p, "key", None) for p in path]


def _is_stacked(path) -> bool:
    """Leaves under 'layers'/'enc_layers' carry a leading scan axis."""
    return any(k in ("layers", "enc_layers") for k in _keys(path))


def _is_moe_expert(path) -> bool:
    keys = _keys(path)
    return "moe" in keys and keys[-1] in ("w_gate", "w_up", "w_down")


def param_specs(params_shape, mesh, *, mode: str = "tp",
                expert_parallel: bool = False) -> Any:
    """mode="tp"   — Megatron-style tensor parallel (shard a weight dim);
    mode="fsdp" — shard the stacked *layer* axis over ``model`` (ZeRO-3
    over depth). expert_parallel — shard MoE expert stacks on the
    *expert* dim instead of the per-expert ff dim."""
    ms = model_axis_size(mesh)

    def spec_for(path, leaf):
        stacked = _is_stacked(path)
        if expert_parallel and _is_moe_expert(path):
            edim = 1 if stacked else 0           # (L, E, a, b) / (E, a, b)
            if leaf.shape[edim] % ms == 0:
                spec = [None] * len(leaf.shape)
                spec[edim] = "model"
                return P(*spec)
        if mode == "fsdp" and stacked and leaf.shape[0] % ms == 0:
            return P(*(["model"] + [None] * (len(leaf.shape) - 1)))
        skip = 1 if stacked else 0
        return P(*_shard_param_dims(leaf.shape, ms, skip))

    return tree_map_with_path(spec_for, params_shape)


def _overlay(base: P, dims) -> P:
    """Overlay model-axis dims onto a base spec (None entries keep the
    base's assignment — in practice the lead worker / ring axis)."""
    out = list(base) + [None] * (len(dims) - len(base))
    for i, d in enumerate(dims):
        if d is not None:
            out[i] = d
    return P(*out)


def admm_state_specs(state_shape: ADMMTrainState, mesh, *, mode: str = "tp",
                     expert_parallel: bool = False) -> ADMMTrainState:
    """Specs for the trainer's ``ADMMTrainState(z_hist, y, w_cache,
    step)``: ``core.sharded``'s base layout + this module's TP overlay
    (the reference's also places its rng key, which the port's state
    does not carry)."""
    ms = model_axis_size(mesh)
    daxes = data_axes(mesh)

    def _ep_spec(path, leaf, lead):
        if expert_parallel and _is_moe_expert(path):
            edim = lead + (1 if _is_stacked(path) else 0)
            if edim < len(leaf.shape) and leaf.shape[edim] % ms == 0:
                spec = [None] * len(leaf.shape)
                spec[edim] = "model"
                return spec
        return None

    def _model_dims(path, leaf):
        """The TP overlay: which (non-lead) dim carries ``model``."""
        ep = _ep_spec(path, leaf, 1)
        if ep is not None:
            return ep
        stacked = _is_stacked(path)
        if mode == "fsdp" and stacked and len(leaf.shape) > 1 \
                and leaf.shape[1] % ms == 0:
            return [None, "model"] + [None] * (len(leaf.shape) - 2)
        skip = 2 if stacked else 1                 # (lead, [L], ...)
        return [None] + _shard_param_dims(leaf.shape, ms, skip)[1:]

    def z_spec(path, leaf):
        return _overlay(ring_spec(leaf.dim()), _model_dims(path, leaf))

    def worker_spec(path, leaf):
        return _overlay(worker_bundle_spec(leaf.dim(), daxes),
                        _model_dims(path, leaf))

    return ADMMTrainState(
        z_hist=tree_map_with_path(z_spec, state_shape.z_hist),
        y=tree_map_with_path(worker_spec, state_shape.y),
        w_cache=tree_map_with_path(worker_spec, state_shape.w_cache),
        step=P())


def batch_specs(batch_shape, mesh, *, worker_axis: bool) -> Any:
    daxes = data_axes(mesh)
    ndev = num_workers(mesh)

    def spec_for(leaf):
        if worker_axis:
            return P(*([daxes] + [None] * (len(leaf.shape) - 1)))
        if leaf.shape and leaf.shape[0] % ndev == 0 and leaf.shape[0] >= ndev:
            return P(*([daxes] + [None] * (len(leaf.shape) - 1)))
        return P(*([None] * len(leaf.shape)))

    return tree_map(spec_for, batch_shape)


def cache_specs_tree(cache_shape, mesh, batch: int) -> Any:
    """Decode cache placement. Leaves (layer-stacked):
       gqa k/v:      (L, B, S, nkv, hd)   -> B over data (if divisible),
                                            S over model
       mla c_kv:     (L, B, S, rank)      -> same
       ssm conv:     (L, B, W-1, convdim) -> B data, convdim model
       ssm state:    (L, B, h, n, p)      -> B data, h over model if div.
       cross k/v:    (L, B, T, nkv, hd)   -> B data, T model
    Heuristic: leading (L,) skipped; batch dim -> data if divisible; the
    largest remaining dim divisible by the model size -> model."""
    daxes = data_axes(mesh)
    ndev = num_workers(mesh)
    ms = model_axis_size(mesh)

    def spec_for(leaf):
        shape = leaf.shape
        dims = [None] * len(shape)
        # dim 0 = layer stack, dim 1 = batch
        if len(shape) >= 2 and shape[1] % ndev == 0 and shape[1] >= ndev:
            dims[1] = daxes
        best, best_size = None, 0
        for i in range(2, len(shape)):
            if shape[i] % ms == 0 and shape[i] >= ms and shape[i] > best_size:
                best, best_size = i, shape[i]
        if best is not None:
            dims[best] = "model"
        return P(*dims)

    return tree_map(spec_for, cache_shape)

