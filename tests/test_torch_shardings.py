"""The port's placement rules (``repro_torch/launch/shardings.py``, the
spec type and ``local_shard`` of ``launch/mesh.py``, the base specs of
``core/sharded.py``) against the reference's ``launch/shardings.py``.

For all ten archs at full width, on the pod (data=16, model=16) and
multi-pod (pod=2, data=16, model=16) shapes, leaf for leaf:
``param_specs`` (tp, fsdp, expert_parallel), ``admm_state_specs`` over
the trainer's state (the dry run's bf16 config), ``batch_specs`` in both
worker modes and ``cache_specs_tree`` at decode_32k, and the per-device
bytes of each placement against the same arithmetic on the reference's
specs. The reference's shapes come from ``model.param_specs()``,
``jax.eval_shape(trainer.init)`` and ``model.cache_specs``; its mesh is
a ``SimpleNamespace(axis_names=..., shape=...)`` (the installed jax
rejects the ``AbstractMesh`` form). The shapes are computed once an arch
and serve both meshes. The reference's ``init_params`` traces its
stacks layer by layer (seconds an arch at full depth), so its params are
traced with one layer a stack and each stack's leading axis set to the
config's depth: ``init_params`` stacks ``num_layers`` layers under
``layers`` and ``encoder_layers`` under ``enc_layers``, and nothing
else depends on depth (``test_reference_shapes_at_full_depth`` holds
the two to each other on an arch).
"""
import functools
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import get_config as ref_config
from repro.configs.base import ADMMConfig as RConfig
from repro.launch import shardings as rsh
from repro.models import build_model as ref_build
from repro.training.trainer import ADMMTrainer as RTrainer
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke, list_archs
from repro_torch.configs.base import ADMMConfig
from repro_torch.core.sharded import (consensus_state_specs, tile_for,
                                      worker_bundle_spec)
from repro_torch.core.space import init_consensus_state
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import (P, local_shard, make_abstract_mesh,
                                     shard_shape)
from repro_torch.models import build_model, weights
from repro_torch.training import ADMMTrainer

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
DTYPE = "bfloat16"


def _ns(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _workers(name):
    shape, axes = MESHES[name]
    return math.prod(s for s, a in zip(shape, axes) if a != "model")


def _admm(M=16):
    return dict(rho=100.0, gamma=0.01, max_delay=1, block_fraction=1.0,
                num_blocks=M)


def _ref_param_shapes(rcfg):
    """The reference's full-depth param shapes of ``rcfg``, traced at one
    layer a stack (see the module's docstring)."""
    depth = {"layers": rcfg.num_layers, "enc_layers": rcfg.encoder_layers}
    one = ref_build(rcfg.with_(
        num_layers=1, encoder_layers=min(rcfg.encoder_layers, 1))
    ).param_specs()

    def deepen(path, leaf):
        stack = path[0].key if path[0].key in depth else None
        if stack is None:
            return leaf
        return jax.ShapeDtypeStruct((depth[stack],) + leaf.shape[1:],
                                    leaf.dtype)
    return jax.tree_util.tree_map_with_path(deepen, one)


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """Both packages' full-width shapes for ``arch`` in the dry run's
    bf16 config: params, the trainer's state for each mesh's N, and the
    decode_32k cache."""
    rcfg = ref_config(arch).with_(dtype=DTYPE, param_dtype=DTYPE, remat=True)
    cfg = get_config(arch).with_(dtype=DTYPE, param_dtype=DTYPE, remat=True)
    rmodel, model = ref_build(rcfg), build_model(cfg)
    rparams, params = _ref_param_shapes(rcfg), model.param_specs()
    states = {}
    for name in MESHES:
        N = _workers(name)
        rt = RTrainer(loss_fn=rmodel.loss, admm=RConfig(**_admm()),
                      num_workers=N)
        tt = ADMMTrainer(loss_fn=model.loss, admm=ADMMConfig(**_admm()),
                         num_workers=N, device="meta")
        states[N] = (jax.eval_shape(rt.init, rparams), tt.init(params))
    shape = INPUT_SHAPES["decode_32k"]
    caches = (rmodel.cache_specs(shape.global_batch, shape.seq_len),
              model.init_cache(shape.global_batch, shape.seq_len, "meta"))
    return (rparams, params), states, caches


def _ref_leaves(specs):
    return [tuple(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))]


def _port_leaves(specs):
    return [tuple(s) for s in tree_leaves(specs, is_leaf=sh.is_spec)
            if isinstance(s, P)]


def _ref_bytes(shapes, specs, mesh):
    """The per-device bytes of the reference's placement: each leaf's
    dims divided by the product of their axes' sizes."""
    total = 0
    for leaf, spec in zip(jax.tree.leaves(shapes), _ref_leaves(specs)):
        local = list(leaf.shape)
        for i, e in enumerate(spec):
            axes = () if e is None else (e if isinstance(e, tuple) else (e,))
            n = math.prod(mesh.shape[a] for a in axes)
            assert local[i] % n == 0
            local[i] //= n
        total += math.prod(local) * np.dtype(leaf.dtype).itemsize
    return total


def _same(ref_specs, port_specs, what):
    ref, port = _ref_leaves(ref_specs), _port_leaves(port_specs)
    assert len(ref) == len(port), what
    bad = [(i, r, p) for i, (r, p) in enumerate(zip(ref, port)) if r != p]
    assert not bad, f"{what}: leaf (index, reference, port) {bad[:5]}"


def _abstract(name):
    return make_abstract_mesh(*MESHES[name])


@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_reference_leaf_for_leaf(arch):
    """param_specs (tp, fsdp, expert_parallel), admm_state_specs,
    batch_specs (both modes) and cache_specs_tree at decode_32k, on both
    production meshes, and the per-device bytes of each placement."""
    (rparams, params), states, (rcache, cache) = _shapes(arch)
    shape = INPUT_SHAPES["train_4k"]
    for name in MESHES:
        rmesh, mesh = _ns(name), _abstract(name)
        for kw in ({}, {"mode": "fsdp"}, {"expert_parallel": True}):
            rs = rsh.param_specs(rparams, rmesh, **kw)
            ps = sh.param_specs(params, mesh, **kw)
            _same(rs, ps, f"{name} param_specs {kw}")
            assert dryrun.spec_bytes(params, ps, mesh) == \
                _ref_bytes(rparams, rs, rmesh)
        rstate, state = states[_workers(name)]
        for kw in ({}, {"mode": "fsdp"}, {"expert_parallel": True}):
            rs = rsh.admm_state_specs(rstate, rmesh, **kw)
            ps = sh.admm_state_specs(state, mesh, **kw)
            for field in ("z_hist", "y", "w_cache"):
                _same(getattr(rs, field), getattr(ps, field),
                      f"{name} admm_state_specs {kw} {field}")
                assert dryrun.spec_bytes(
                    getattr(state, field), getattr(ps, field), mesh) == \
                    _ref_bytes(getattr(rstate, field), getattr(rs, field),
                               rmesh)
        N = _workers(name)
        for worker_axis, lead in ((True, (N, shape.global_batch // N,
                                          shape.seq_len)),
                                  (False, (shape.global_batch, 8)),
                                  (False, (3, 8))):
            rb = {"tokens": jax.ShapeDtypeStruct(lead, np.int32)}
            pb = {"tokens": torch.empty(lead, dtype=torch.int32,
                                        device="meta")}
            _same(rsh.batch_specs(rb, rmesh, worker_axis=worker_axis),
                  sh.batch_specs(pb, mesh, worker_axis=worker_axis),
                  f"{name} batch_specs {worker_axis} {lead}")
        B = INPUT_SHAPES["decode_32k"].global_batch
        rs = rsh.cache_specs_tree(rcache, rmesh, B)
        ps = sh.cache_specs_tree(cache, mesh, B)
        _same(rs, ps, f"{name} cache_specs_tree")
        assert dryrun.spec_bytes(cache, ps, mesh) == \
            _ref_bytes(rcache, rs, rmesh)


def test_reference_shapes_at_full_depth():
    """The one-layer trace extended to the config's depth is the
    reference's full trace, on the enc-dec (two stacks) and the hybrid
    (a shared block beside its stack)."""
    for arch in ("whisper-medium", "zamba2-1.2b"):
        rcfg = ref_config(arch).with_(dtype=DTYPE, param_dtype=DTYPE)
        want = ref_build(rcfg).param_specs()
        got = _ref_param_shapes(rcfg)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        assert jax.tree.leaves(got) == jax.tree.leaves(want)


def test_spec_type_and_local_shapes():
    """A spec stores a one-name tuple as the name, as jax does; the local
    shape and shard of a placement on any rank's view; a dim that does
    not divide is refused; the abstract mesh lays ranks out row-major."""
    assert P(("data",), None) == ("data", None) == tuple(
        PartitionSpec(("data",), None))
    assert P(("pod", "data"), "model")[0] == ("pod", "data")
    mesh = make_abstract_mesh((2, 4, 2), ("pod", "data", "model"), rank=13)
    assert mesh.coords == {"pod": 1, "data": 2, "model": 1}
    assert mesh.worker_shard_index == 6
    x = torch.arange(16 * 6 * 4).reshape(16, 6, 4)
    spec = P(("pod", "data"), "model")
    assert shard_shape(x.shape, spec, mesh) == (2, 3, 4)
    np.testing.assert_array_equal(local_shard(x, spec, mesh),
                                  x[12:14, 3:6])
    with pytest.raises(ValueError, match="does not divide"):
        local_shard(torch.zeros(5, 6), spec, mesh)
    with pytest.raises(ValueError, match="outside the mesh"):
        make_abstract_mesh((2, 2), ("data", "model"), rank=4)


@pytest.mark.parametrize("mesh_shape,axes,N,M", [
    ((16, 16), ("data", "model"), 16, 16),
    ((2, 2, 2), ("pod", "data", "model"), 8, 4),     # split gradients
    ((4,), ("data",), 8, 6)])
def test_tile_is_the_shard_of_the_base_specs(mesh_shape, axes, N, M):
    """On every rank's view, the trainer's tile of an (N, M, dblk) bundle
    is ``local_shard`` of it under ``worker_bundle_spec``, and of a ring
    under the state specs; the tiles cover the grid once."""
    dblk = 3
    bundle = torch.arange(N * M * dblk).reshape(N, M, dblk)
    cover = torch.zeros(N, M, dtype=torch.int64)
    for rank in range(math.prod(mesh_shape)):
        mesh = make_abstract_mesh(mesh_shape, axes, rank)
        tile = tile_for(mesh, N, M)
        mname = "model" if "model" in axes else None
        daxes = tuple(a for a in axes if a != "model")
        got = local_shard(bundle, worker_bundle_spec(3, daxes, mname), mesh)
        np.testing.assert_array_equal(got, tile.cols(tile.rows(bundle)))
        cover[tile.n0:tile.n0 + tile.Nl, tile.m0:tile.m0 + tile.Ml] += 1
        rows = torch.arange(N)
        assert tile.grad_rows(rows).tolist() == list(range(
            tile.n0 + tile.g0, tile.n0 + tile.g0 + tile.Ng))
    assert torch.equal(cover, torch.ones_like(cover))


def test_consensus_state_specs_place_the_packed_state():
    """The packed state's base specs: the ring replicated over data, the
    worker bundles over the data axes, the block axis over model; a
    rank's ``local_shard`` of the single-device state is the state
    ``init_consensus_state`` builds on that rank's view."""
    model = build_model(get_smoke("qwen3-1.7b"))
    params = weights.stacked_params(get_smoke("qwen3-1.7b"), 0, "cpu")
    full_tr = ADMMTrainer(loss_fn=model.loss, admm=ADMMConfig(**_admm(4)),
                          num_workers=4, device="cpu")
    full = init_consensus_state(full_tr._spec(params), params)
    for rank in range(4):
        mesh = make_abstract_mesh((2, 2), ("data", "model"), rank)
        tr = ADMMTrainer(loss_fn=model.loss, admm=ADMMConfig(**_admm(4)),
                         num_workers=4, mesh=mesh, device="cpu")
        spec = tr._spec(params)
        local = init_consensus_state(spec, params)
        specs = consensus_state_specs(spec, full)
        assert specs.z_hist == P(None, "model", None)
        assert specs.y == specs.w_cache == P("data", "model", None)
        assert specs.x is None
        for k in ("z_hist", "y", "w_cache"):
            assert torch.equal(local_shard(getattr(full, k),
                                           getattr(specs, k), mesh),
                               getattr(local, k))
