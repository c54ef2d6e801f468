"""Meshes of ``torch.distributed`` ranks, and mesh-shape helpers.

Port of ``repro/launch/mesh.py``. A :class:`Mesh` lays the ranks of the
default process group out row-major over its axes, as ``jax.make_mesh``
lays out devices, and carries the two process groups the SPMD epoch
(``core/sharded.py``) talks over:

* the *data group* — the ranks that share this rank's ``model`` index;
  ``pod`` and ``data`` flattened row-major, so a rank's place in the
  group is its worker-shard index;
* the *model group* — the ranks that share this rank's ``pod`` and
  ``data`` indices; a rank's place in it is its ``model`` index.

Axis convention: ``data`` (+ optional outer ``pod``) shards the *worker*
axis of the consensus state — each worker's duals / w-cache live with its
data shard — and ``model`` shards the *block-server* axis.

Production target: 256 ranks (16x16), optionally 2 pods.
  single pod : (data=16, model=16)            axes ("data", "model")
  multi pod  : (pod=2, data=16, model=16)     axes ("pod", "data", "model")

Nothing here runs at import time. Building a mesh needs an initialised
default process group (``torch.distributed.init_process_group``, given
its address, world size and rank) with at least as many ranks as the
mesh; every rank of that group must build the same meshes in the same
order, because each build creates process groups.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch.distributed as dist

MESH_AXES = ("pod", "data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (pod, data, model) mesh of ranks."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]            # axis -> size, in axis order
    coords: Dict[str, int]           # this rank's index on each axis
    data_group: Any                  # ProcessGroup over pod x data
    model_group: Any                 # ProcessGroup over model

    @property
    def worker_shard_index(self) -> int:
        """Row-major index of this rank over the data axes."""
        wi = 0
        for a in data_axes(self):
            wi = wi * self.shape[a] + self.coords[a]
        return wi

    @property
    def model_index(self) -> int:
        return self.coords.get("model", 0)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """A mesh of ``prod(shape)`` ranks of the default process group,
    laid out row-major over ``axes`` (a subset of pod, data, model)."""
    if not set(axes) <= set(MESH_AXES) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes} unknown; expected distinct "
                         f"names from {MESH_AXES}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "building a mesh needs an initialised default process group: "
            "call torch.distributed.init_process_group(backend, "
            "init_method=..., world_size=..., rank=...) in every rank first")
    n = math.prod(shape)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world < n:
        raise RuntimeError(f"mesh {dict(zip(axes, shape))} needs {n} ranks; "
                           f"the process group has {world}")
    grid = np.arange(n).reshape(shape)
    if "model" in axes:
        grid = np.moveaxis(grid, axes.index("model"), -1)
    else:
        grid = grid[..., None]
    rows = grid.reshape(-1, grid.shape[-1])      # (data shards, model)
    # every rank creates every group, in one order: data groups, then
    # model groups; rank order inside a group is row-major mesh order
    data_groups = [dist.new_group(rows[:, m].tolist())
                   for m in range(rows.shape[1])]
    model_groups = [dist.new_group(r.tolist()) for r in rows]
    if rank >= n:
        raise RuntimeError(f"rank {rank} lies outside the mesh of {n} ranks")
    wi, mi = np.argwhere(rows == rank)[0]
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    return Mesh(axis_names=tuple(axes), shape=dict(zip(axes, shape)),
                coords=coords, data_group=data_groups[mi],
                model_group=model_groups[wi])


def make_abstract_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
                       rank: int = 0) -> Mesh:
    """Rank ``rank``'s view of a mesh of ``prod(shape)`` ranks (laid out
    row-major, as :func:`make_mesh` lays them), with no process group
    and no groups: what ``core.sharded.per_shard_cost_program`` needs to
    cost one shard, and what a test needs to take any rank's tile (the
    reference's ``AbstractMesh``). Its collectives cannot run."""
    if not set(axes) <= set(MESH_AXES) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh axes {axes} unknown; expected distinct "
                         f"names from {MESH_AXES}")
    n = math.prod(shape)
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} lies outside the mesh of {n} ranks")
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(rank, shape))))
    return Mesh(axis_names=tuple(axes), shape=dict(zip(axes, shape)),
                coords=coords, data_group=None, model_group=None)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_test_mesh(devices: int = 8, model: int = 2) -> Mesh:
    """Small (data, model) mesh for integration tests: ``devices`` ranks
    split into ``model`` columns — validated eagerly so a bad count fails
    with an actionable message instead of an opaque reshape error."""
    if model <= 0 or devices <= 0:
        raise ValueError(f"devices={devices} and model={model} must be >= 1")
    if devices % model != 0:
        raise ValueError(
            f"make_test_mesh: devices={devices} does not divide into "
            f"model={model} columns (devices % model == {devices % model}); "
            f"pick devices as a multiple of the model axis")
    return make_mesh((devices // model, model), ("data", "model"))


MESH_PRESETS = ("none", "test", "pod", "multipod")
_PRESET_BUILDERS = {
    "test": make_test_mesh,
    "pod": make_production_mesh,
    "multipod": lambda: make_production_mesh(multi_pod=True),
}
# preset name -> (the default process group it was built over, its mesh)
_preset_meshes: Dict[str, Tuple[Any, Mesh]] = {}


def resolve_mesh(mesh):
    """Resolve an ``ADMMConfig.mesh`` value to a :class:`Mesh` or None.

    Accepts None / "none" (single-device epoch), an already-built mesh
    (anything with ``axis_names``), or a preset name: ``test`` (8 ranks,
    data=4 x model=2), ``pod``, ``multipod``. A preset's mesh is built
    once per default process group, on its first resolution (a
    collective: every rank resolves it, in one order), and the same mesh
    is returned after that, so building specs creates no more groups."""
    if mesh is None or mesh == "none":
        return None
    if hasattr(mesh, "axis_names"):
        return mesh
    if mesh not in _PRESET_BUILDERS:
        raise ValueError(f"unknown mesh {mesh!r}; expected None, a Mesh, "
                         f"or one of {MESH_PRESETS}")
    world = dist.group.WORLD if dist.is_available() else None
    hit = _preset_meshes.get(mesh)
    if hit is not None and world is not None and hit[0] is world:
        return hit[1]
    built = _PRESET_BUILDERS[mesh]()
    _preset_meshes[mesh] = (world, built)
    return built


def data_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def num_workers(mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= mesh.shape[a]
    return n


def model_axis_size(mesh) -> int:
    return mesh.shape.get("model", 1)


# ---------------------------------------------------------------------------
# placement specs: the counterpart of jax.sharding.PartitionSpec
# ---------------------------------------------------------------------------

class P(tuple):
    """A placement spec, the counterpart of ``jax.sharding.PartitionSpec``:
    one entry a tensor dim, each ``None`` (replicated), an axis name, or
    a tuple of axis names (the dim split over their product, row-major:
    the data axes ``("pod", "data")``). A one-name tuple is stored as the
    name, as jax stores it. Dims past the entries are replicated."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else (e or None)
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes dim ``dim`` is split over, outermost first."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return e if isinstance(e, tuple) else (e,)


def _dim_slice(mesh, axes, size: int, dim: int) -> Tuple[int, int]:
    """(start, length) of this rank's share of a dim of ``size`` split
    over ``axes``; an axis the mesh lacks counts as size 1."""
    n, idx = 1, 0
    for a in axes:
        k = mesh.shape.get(a, 1)
        n, idx = n * k, idx * k + mesh.coords.get(a, 0)
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not divide over "
                         f"the {n} shards of mesh axes {axes}")
    return idx * (size // n), size // n


def shard_slices(shape, spec: P, mesh) -> Tuple[Tuple[int, int], ...]:
    """Per dim of ``shape``, (start, length) of this rank's shard under
    ``spec`` on ``mesh`` (``mesh.coords``); a dim that does not divide
    is refused."""
    return tuple(_dim_slice(mesh, spec.axes(i), int(s), i)
                 for i, s in enumerate(shape))


def shard_shape(shape, spec: P, mesh) -> Tuple[int, ...]:
    """The local shape of a ``shape`` tensor placed by ``spec``."""
    return tuple(n for _, n in shard_slices(shape, spec, mesh))


def local_shard(x, spec: P, mesh):
    """This rank's shard of the full tensor ``x`` placed by ``spec``: the
    port's counterpart of ``jax.device_put(x, NamedSharding(mesh,
    spec))`` as one device sees it (a view of ``x``)."""
    for dim, (start, n) in enumerate(shard_slices(x.shape, spec, mesh)):
        if n != x.shape[dim]:
            x = x.narrow(dim, start, n)
    return x
