"""The tree half of the port's ``core/blocks.py`` (``TreeBlocks``, the LPT
``make_tree_blocks``, ``BlockLayout``, ``make_block_layout``) and its
flattener ``core/tree.py``, against the reference's.

Mirrors tests/test_block_layout.py:39-159 and its epoch case: ragged
trees, leading batch axes, mixed f32/bf16/f16 leaves (bitwise), the
structure checks, the block-id contract, lane rounding and inert
padding. Beyond it: leaf order, ``leaf_block_ids`` and ``leaf_offsets``
equal to the reference's for dicts inserted in any order, trees with
``None`` and NamedTuples, qwen3-1.7b's stacked parameter tree at 12
and 28 layers, and mamba2-370m's and zamba2-1.2b's (whose unstacked
``shared_attn`` subtree sorts in after ``layers`` and ``lm_head``) at
full width (``jax.eval_shape`` on one side, ``meta`` tensors on the
other); and the round-trip property under hypothesis, held against the
reference's table.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ConsensusSession as RSession
from repro.configs import qwen3_1p7b as rqwen
from repro.configs.base import ADMMConfig as RConfig
from repro.core import blocks as rblocks
from repro.models.model import build_model
from repro_torch.api import ConsensusSession
from repro_torch.configs import qwen3_1p7b
from repro_torch.configs.base import ADMMConfig
from repro_torch.core import blocks, tree
from repro_torch.kernels import ops
from repro_torch.models.weights import stacked_params

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _pair(tree_np, dtypes=None):
    """(port tree of tensors, reference tree of arrays) holding the same
    values: float32 numpy leaves, each rounded to its dtype in each
    package (both round to nearest even)."""
    dtypes = dtypes or {}

    def port(path, a):
        return torch.as_tensor(a).to(DTYPES[dtypes.get(path, "float32")][0])

    def ref(path, a):
        return jnp.asarray(a).astype(DTYPES[dtypes.get(path, "float32")][1])

    def walk(x, fn, path=""):
        if isinstance(x, dict):
            return type(x)((k, walk(v, fn, f"{path}/{k}"))
                           for k, v in x.items())
        if x is None:
            return None
        if isinstance(x, tuple) and hasattr(type(x), "_fields"):
            return type(x)(*(walk(v, fn, f"{path}/{i}")
                             for i, v in enumerate(x)))
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v, fn, f"{path}/{i}") for i, v in enumerate(x))
        return fn(path, x)
    return walk(tree_np, port), walk(tree_np, ref)


def _ragged_tree():
    """Odd shapes on purpose: scalars, vectors, matrices, 3-d leaves."""
    r = np.random.RandomState(0)
    return {
        "bias": np.asarray(r.randn(), np.float32),
        "w1": r.randn(7).astype(np.float32),
        "w2": r.randn(3, 5).astype(np.float32),
        "deep": {"w3": r.randn(2, 2, 3).astype(np.float32),
                 "w4": r.randn(11).astype(np.float32)},
    }


class Pair(collections.namedtuple("Pair", ["left", "right"])):
    pass


def _odd_tree():
    """Dicts inserted out of order, None nodes, lists, tuples, a
    NamedTuple and an OrderedDict."""
    r = np.random.RandomState(1)
    v = lambda *s: r.randn(*s).astype(np.float32)   # noqa: E731
    return {"zeta": v(5), "alpha": {"y": v(3, 2), "b": None, "a": v(9)},
            "mid": [v(4), None, (v(2), v(6, 2))],
            "nt": Pair(left=v(8), right=None),
            "od": collections.OrderedDict([("q", v(7)), ("c", v(1))]),
            "empty": {}, "none": None}


def _assert_same_layout(tl, rl, mask=True):
    assert tl.block_ids == rl.block_ids
    assert tl.leaf_offsets == rl.leaf_offsets
    assert tl.leaf_shapes == rl.leaf_shapes
    assert tl.leaf_dtypes == rl.leaf_dtypes
    assert tl.block_leaves == rl.block_leaves
    assert tl.block_sizes == rl.block_sizes
    assert tl.block_dim == rl.block_dim
    assert tl.leaf_starts() == rl.leaf_starts()
    if mask:          # (M, dblk) bools: at full width, gigabytes
        np.testing.assert_array_equal(tl.padding_mask(), rl.padding_mask())


def _bits(t):
    """A tensor's raw bytes, the reference's array's the same way."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.asarray(t).reshape(-1).view(np.uint8)


# ---------------------------------------------------------------------------
# the flattener: JAX's leaf order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [_ragged_tree, _odd_tree])
def test_flatten_matches_jax(make):
    tnp = make()
    leaves, treedef = tree.tree_flatten(tnp)
    rleaves = jax.tree.leaves(tnp)
    assert len(leaves) == len(rleaves) == treedef.num_leaves
    for a, b in zip(leaves, rleaves):
        assert a is b
    back = tree.tree_unflatten(treedef, leaves)
    assert tree.tree_structure(back) == treedef
    assert jax.tree.structure(back) == jax.tree.structure(tnp)
    if "od" in tnp:
        assert type(back["od"]) is collections.OrderedDict
    assert tree.tree_map(lambda a: a.shape, tnp) == \
        jax.tree.map(lambda a: a.shape, tnp)


def test_treedefs_compare_by_structure():
    a = {"b": np.zeros(2), "a": np.zeros(3)}
    b = {"a": np.zeros(3), "b": np.zeros(2)}
    assert tree.tree_structure(a) == tree.tree_structure(b)
    assert hash(tree.tree_structure(a)) == hash(tree.tree_structure(b))
    assert tree.tree_structure(a) != tree.tree_structure({"a": 0})
    assert tree.tree_structure([1, 2]) != tree.tree_structure((1, 2))
    with pytest.raises(ValueError, match="leaves"):
        tree.tree_unflatten(tree.tree_structure(a), [1])


def test_flatten_and_pack_hold_no_reference_cycle():
    """A leaf is freed as soon as its last holder lets it go: flatten,
    unflatten, pack and unpack leave no cycle behind (a recursive
    closure's would keep an epoch's device tensors alive until the cycle
    collector runs)."""
    import gc
    import weakref
    gc.disable()
    try:
        leaf = torch.ones(3)
        ref = weakref.ref(leaf)
        params = {"b": [leaf, None], "a": torch.zeros(2)}
        layout = blocks.make_block_layout(params, num_blocks=2)
        table = layout.to_blocks(params)
        back = tree.tree_map(lambda x: x, layout.from_blocks(table))
        del leaf, params
        assert ref() is None
        view = weakref.ref(back["b"][0])
        del back
        assert view() is None
    finally:
        gc.enable()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


@pytest.mark.parametrize("discipline", ["lockfree", "locked"])
def test_a_ps_round_holds_no_reference_cycle(discipline):
    """A finished ``run_ps`` round frees its state (the workers' y and w
    bundles, the block servers' w caches and z versions) as soon as the
    caller lets the runtime go: the workers, servers and fault injector
    refer back to the runtime weakly and the metric instruments close
    over its parts, so no cycle holds those tensors until the cycle
    collector runs (it held ~3 GB at KDDa width)."""
    import gc
    import weakref
    from repro_torch.api import ConsensusSession
    from repro_torch.configs.base import ADMMConfig
    from repro_torch.ps import PSRuntime
    params = {"b": [torch.ones(3), None], "a": torch.zeros(2)}
    sess = ConsensusSession.pytree(
        lambda p, c: torch.sum(torch.square(p["a"] - c))
        + torch.sum(p["b"][0]) * c[0],
        params, ADMMConfig(num_blocks=2, max_delay=1), num_workers=2,
        device="cpu")
    batch = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    # a first run imports what torch.func loads lazily; an exception
    # raised and handled inside that import keeps its frames, and so
    # that run, in a traceback cycle
    sess.run_ps(1, batches=lambda t: batch, discipline=discipline)
    gc.collect()
    gc.disable()
    try:
        rt = PSRuntime(sess.spec, batches=lambda t: batch,
                       discipline=discipline)
        res = rt.run(1, z0=params)
        held = list(_tensors([rt.y, rt.w,
                              [d.caches for d in rt.domains],
                              [d.contents for d in rt.domains]]))
        assert len(held) >= 2 + 2 * len(rt.domains)
        refs = [weakref.ref(t) for t in held]
        del rt, res, held
        assert [r for r in refs if r() is not None] == []
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# tests/test_block_layout.py, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [_ragged_tree, _odd_tree])
@pytest.mark.parametrize("m", [1, 2, 3, 7])     # 7 > num leaves: empty blocks
def test_roundtrip_ragged_tree(make, m):
    tt, rt = _pair(make())
    layout = blocks.make_block_layout(tt, num_blocks=m)
    _assert_same_layout(layout, rblocks.make_block_layout(rt, num_blocks=m))
    packed = layout.to_blocks(tt)
    assert packed.shape == (m, layout.block_dim)
    assert max(layout.block_sizes) <= layout.block_dim
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(rblocks.make_block_layout(
            rt, num_blocks=m).to_blocks(rt)))
    back = layout.from_blocks(packed)
    assert tree.tree_structure(back) == tree.tree_structure(tt)
    for a, b in zip(tree.tree_leaves(tt), tree.tree_leaves(back)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    np.testing.assert_array_equal(packed.numpy()[~layout.padding_mask()], 0.0)


def test_roundtrip_leading_batch_axes():
    """Worker bundles (N, ...) and ring buffers (D+1, ...) pack through
    the same layout — leading axes pass straight through."""
    tt, rt = _pair(_ragged_tree())
    layout = blocks.make_block_layout(tt, num_blocks=3)
    rlayout = rblocks.make_block_layout(rt, num_blocks=3)
    for lead in ((4,), (2, 4)):
        batched = tree.tree_map(
            lambda a: a.expand(lead + tuple(a.shape)).clone(), tt)
        packed = layout.to_blocks(batched)
        assert packed.shape == lead + (3, layout.block_dim)
        np.testing.assert_array_equal(
            packed.numpy(), np.asarray(rlayout.to_blocks(jax.tree.map(
                lambda a: jnp.broadcast_to(a, lead + a.shape), rt))))
        back = layout.from_blocks(packed)
        for a, b in zip(tree.tree_leaves(batched), tree.tree_leaves(back)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("size", [9, 127, 128, 129])
def test_roundtrip_mixed_dtypes_bitwise(size):
    """bf16/f16 leaves embed losslessly in the f32 compute dtype: the
    round trip is bit-exact, each leaf comes back in its stored dtype,
    and the packed table is the reference's bit for bit (including at
    the 128-lane boundary)."""
    r = np.random.RandomState(size)
    tnp = {"f32": r.randn(size).astype(np.float32),
           "bf16": r.randn(4, size).astype(np.float32),
           "f16": r.randn(size).astype(np.float32)}
    tt, rt = _pair(tnp, {"/bf16": "bfloat16", "/f16": "float16"})
    layout = blocks.make_block_layout(tt, num_blocks=3)
    rlayout = rblocks.make_block_layout(rt, num_blocks=3)
    _assert_same_layout(layout, rlayout)
    packed = layout.to_blocks(tt)
    assert packed.dtype == torch.float32 and packed.shape[-1] % 128 == 0
    np.testing.assert_array_equal(_bits(packed), _bits(rlayout.to_blocks(rt)))
    back = layout.from_blocks(packed)
    rback = rlayout.from_blocks(rlayout.to_blocks(rt))
    for a, b, c in zip(tree.tree_leaves(tt), tree.tree_leaves(back),
                       jax.tree.leaves(rback)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(_bits(b), _bits(c))
    np.testing.assert_array_equal(packed.numpy()[~layout.padding_mask()], 0.0)


def test_layout_validates_structure():
    tt, _ = _pair(_ragged_tree())
    layout = blocks.make_block_layout(tt, num_blocks=2)
    with pytest.raises(ValueError, match="structure"):
        layout.to_blocks({"other": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        layout.to_blocks(dict(tt, w1=torch.zeros(8)))   # w1 is (7,)
    with pytest.raises(ValueError, match="empty"):
        blocks.make_block_layout({}, num_blocks=2)
    with pytest.raises(ValueError, match="empty"):
        blocks.make_block_layout({"a": None}, num_blocks=2)
    tb = blocks.make_tree_blocks(tt, 2)
    with pytest.raises(ValueError, match="structure"):
        blocks.make_block_layout({"other": torch.zeros(3)}, tb)


def test_block_id_contract():
    """Block ids follow TreeBlocks' assignment and rows pack the
    block's leaves in leaf order at the recorded offsets."""
    tnp = {"c": np.arange(7.0, 9.0, dtype=np.float32),
           "a": np.arange(3.0, dtype=np.float32),
           "b": np.arange(3.0, 7.0, dtype=np.float32)}
    tt, rt = _pair(tnp)
    tb = blocks.make_tree_blocks(tt, 2)
    rb = rblocks.make_tree_blocks(rt, 2)
    assert tb.leaf_block_ids == rb.leaf_block_ids
    layout = blocks.make_block_layout(tt, tb)
    assert layout.block_ids == tb.leaf_block_ids
    packed = layout.to_blocks(tt).numpy()
    for k, leaf in enumerate(tree.tree_leaves(tt)):
        j, off = layout.block_ids[k], layout.leaf_offsets[k]
        np.testing.assert_array_equal(packed[j, off:off + leaf.numel()],
                                      leaf.numpy().ravel())
    # TreeBlocks' helpers, as the reference's
    assert tb.block_id_tree() == rb.block_id_tree()
    sel = np.array([1.0, 0.0], np.float32)
    got = tb.mask_tree(torch.as_tensor(sel))
    want = rb.mask_tree(jnp.asarray(sel))
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}
    np.testing.assert_array_equal(tb.block_sizes(tt), rb.block_sizes(rt))


def test_block_dim_is_lane_rounded():
    tt, _ = _pair(_ragged_tree())
    for m in (1, 2, 3):
        layout = blocks.make_block_layout(tt, num_blocks=m)
        assert layout.block_dim % blocks.LANE == 0
        assert layout.block_dim == blocks.round_up_to_lane(
            max(layout.block_sizes))


def test_from_blocks_views_one_contiguous_table():
    """f32 leaves are views of the table (each reads its own window);
    a non-contiguous table is made contiguous once, not per leaf."""
    tt, _ = _pair(_ragged_tree())
    layout = blocks.make_block_layout(tt, num_blocks=2)
    packed = layout.to_blocks(tt)
    base = packed.data_ptr()
    end = base + packed.numel() * packed.element_size()
    for leaf, start in zip(layout.unpack_leaves(packed), layout.leaf_starts()):
        assert leaf.data_ptr() == base + 4 * start
        assert base <= leaf.data_ptr() < end
    wide = torch.zeros((2, layout.block_dim * 2))
    strided = wide[:, ::2]                     # not contiguous
    strided.copy_(packed)
    for a, b in zip(layout.unpack_leaves(strided), tree.tree_leaves(tt)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("window", [(0, 4), (0, 2), (1, 2), (3, 1)])
def test_block_window_is_rows_of_the_full_table(window):
    """A block window (m0, Ml), a mesh rank's block columns: its table is
    rows [m0, m0 + Ml) of the full table (a leading worker axis passing
    through), its tree holds the leaves of its blocks as views of that
    table and None for every other leaf, and that tree packs back to
    the same rows; (0, M) is the whole layout."""
    tt, _ = _pair(_ragged_tree())
    layout = blocks.make_block_layout(tt, num_blocks=4)
    batched = tree.tree_map(lambda t: torch.stack([t, 2 * t, -t]), tt)
    full = layout.to_blocks(batched)
    m0, Ml = window
    rows = full[:, m0:m0 + Ml].clone()
    ids = layout.window_leaf_ids(window)
    assert ids == tuple(k for k, b in enumerate(layout.block_ids)
                        if m0 <= b < m0 + Ml)
    part = layout.from_blocks(rows, window)
    got = tree.tree_flatten(part)[0]
    assert len(got) == len(ids)
    want = tree.tree_flatten(batched)[0]
    base = rows.data_ptr()
    for k, leaf in zip(ids, got):
        assert torch.equal(leaf, want[k])
        assert rows.data_ptr() <= leaf.data_ptr() < base + 4 * rows.numel()
    assert torch.equal(layout.to_blocks(part, window), rows)
    if Ml == layout.num_blocks:
        assert tree.tree_structure(part) == tree.tree_structure(batched)
    with pytest.raises(ValueError, match="window holds"):
        layout.pack_leaves(got + [got[0]], window)


def test_padding_inert_through_prox_and_edge_mask():
    """Zero pad lanes stay exactly zero through the server step (the
    edge-masked w reduction + prox) and the prox alone."""
    N, M = 3, 2
    tt, _ = _pair({"a": np.ones((100,), np.float32),
                   "b": np.ones((130,), np.float32)})
    layout = blocks.make_block_layout(tt, num_blocks=M)
    pad = ~layout.padding_mask()
    assert pad.any()
    r = np.random.RandomState(7)
    z = layout.to_blocks(tree.tree_map(
        lambda a: torch.as_tensor(r.randn(*a.shape).astype(np.float32)), tt))
    w_cache = torch.stack([z * (k + 1) for k in range(N)])
    edge = torch.as_tensor(r.rand(N, M) < 0.7)
    rho_sum = torch.full((M,), 2.0)
    z_new = ops.server_prox_update(z, w_cache, edge, rho_sum, 0.1, 1e-3, 0.5)
    np.testing.assert_array_equal(z_new.numpy()[pad], 0.0)
    assert float(z_new.abs().max()) > 0.0
    z_prox = ops.prox_consensus(z, z * 0.5, rho_sum, 0.1, 1e-3, 0.5)
    np.testing.assert_array_equal(z_prox.numpy()[pad], 0.0)


def _ragged_sessions():
    """The reference's ragged pytree session (block sizes 13, 12, 4 ->
    dblk 128) and the port's on the same problem."""
    params = {"w2": np.zeros((3, 4), np.float32),
              "w1": np.zeros((13,), np.float32),
              "w0": np.zeros((4,), np.float32)}
    kw = dict(rho=2.0, gamma=0.1, max_delay=0, block_fraction=1.0,
              num_blocks=3, l1_coef=1e-3, clip=0.8, seed=0)
    tt, rt = _pair(params)

    def rloss(p, c):
        z = jnp.concatenate([p["w0"].ravel(), p["w1"].ravel(),
                             p["w2"].ravel()])
        return 0.5 * jnp.sum(jnp.square(z - c))

    def tloss(p, c):
        z = torch.cat([p["w0"].ravel(), p["w1"].ravel(), p["w2"].ravel()])
        return 0.5 * torch.sum(torch.square(z - c))
    return (RSession.pytree(rloss, rt, RConfig(**kw), num_workers=3),
            ConsensusSession.pytree(tloss, tt, ADMMConfig(**kw),
                                    num_workers=3, device="cpu"))


def test_padding_never_leaks_into_epoch():
    """Pad lanes stay exactly 0 through real epochs (the z ring, duals,
    w cache and the edge-masked w_sum), and the tables are the
    reference's (a draw-free config: no delay, every block selected)."""
    rsess, sess = _ragged_sessions()
    layout = sess.spec.space.layout
    _assert_same_layout(layout, rsess.spec.space.layout)
    pad = ~layout.padding_mask()
    assert pad.any()
    centers = np.random.RandomState(3).randn(
        3, sum(layout.block_sizes)).astype(np.float32)
    state, rstate = sess.init(), rsess.init()
    for _ in range(6):
        state, _ = sess.step(state, torch.as_tensor(centers))
        rstate, _ = rsess.step(rstate, jnp.asarray(centers))
        for name in ("z_hist", "y", "w_cache"):
            buf = getattr(state, name).numpy()
            np.testing.assert_array_equal(buf[..., pad], 0.0,
                                          err_msg=f"padding leaked into {name}")
            np.testing.assert_allclose(buf, np.asarray(getattr(rstate, name)),
                                       rtol=1e-5, atol=1e-5)
        w_sum = sess.spec.space.reduce_workers(state.w_cache, sess.spec.edge)
        np.testing.assert_array_equal(w_sum.numpy()[pad], 0.0)
    assert float(state.z_hist.abs().max()) > 0.0


# ---------------------------------------------------------------------------
# qwen3-1.7b's stacked parameter tree: LPT ties, shapes only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers,m", [(12, 3), (28, 8), (6, 2)])
def test_qwen3_stacked_tree_layout_matches_reference(layers, m):
    """At full width (shapes only: ``jax.eval_shape`` against ``meta``
    tensors), the LPT assignment with its ties (w_gate / w_up / w_down,
    w_k / w_v, q_norm / k_norm, norm1 / norm2 are equal) and every
    offset are the reference's."""
    rcfg = dataclasses.replace(rqwen.config(), num_layers=layers)
    rshapes = jax.eval_shape(build_model(rcfg).init, jax.random.PRNGKey(0))
    cfg = dataclasses.replace(qwen3_1p7b.config(), num_layers=layers)
    meta = stacked_params(cfg, 0, "meta")
    assert all(leaf.device.type == "meta" for leaf in tree.tree_leaves(meta))
    layout = blocks.make_block_layout(meta, num_blocks=m)
    _assert_same_layout(layout,
                        rblocks.make_block_layout(rshapes, num_blocks=m),
                        mask=False)
    if (layers, m) == (12, 3):
        assert layout.block_sizes == (311_164_928, 302_016_512, 302_017_536)
        assert layout.block_dim == 311_164_928
        names = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(rshapes)[0]]
        ids = dict(zip(names, layout.block_ids))
        assert {n for n, j in ids.items() if j == 1} == {
            "['final_norm']", "['layers']['mlp']['w_down']",
            "['layers']['mlp']['w_up']", "['layers']['norm2']"}


@pytest.mark.parametrize("arch,m", [("mamba2-370m", 2), ("zamba2-1.2b", 2),
                                    ("zamba2-1.2b", 8)])
def test_ssm_and_hybrid_stacked_tree_layout_matches_reference(arch, m):
    """The SSM and hybrid trees at their full widths and depths (shapes
    only): the LPT assignment, offsets and block sizes are the
    reference's, the hybrid's ``shared_attn`` leaves (2-D, not stacked)
    at the reference's places in the leaf order."""
    from repro.configs import get_config as ref_config
    from repro_torch.configs import get_config
    rshapes = jax.eval_shape(build_model(ref_config(arch)).init,
                             jax.random.PRNGKey(0))
    meta = stacked_params(get_config(arch), 0, "meta")
    layout = blocks.make_block_layout(meta, num_blocks=m)
    _assert_same_layout(layout,
                        rblocks.make_block_layout(rshapes, num_blocks=m),
                        mask=False)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(rshapes)[0]]
    assert [tuple(t.shape) for t in tree.tree_leaves(meta)] == \
        [tuple(x.shape) for x in jax.tree.leaves(rshapes)]
    if arch == "zamba2-1.2b":
        assert names[-1] == "['shared_attn']['norm2']"
        assert layout.leaf_shapes[-1] == (2048,)


def test_stacked_params_are_model_init_stacked():
    """``stacked_params(cfg, seed)`` holds ``Model.init(seed)``'s values,
    ``layers`` stacked on a leading axis, in the reference's names."""
    from repro_torch.models.model import Model
    cfg = qwen3_1p7b.smoke()
    stacked = stacked_params(cfg, 3, "cpu")
    per_layer = Model(cfg).init(3, "cpu")
    assert torch.equal(stacked["embed"], per_layer["embed"])
    assert torch.equal(stacked["final_norm"], per_layer["final_norm"])
    for i in range(cfg.num_layers):
        layer = per_layer["layers"][i]
        for group in ("attn", "mlp"):
            for name, value in stacked["layers"][group].items():
                assert torch.equal(value[i], layer[group][name]), name
        for name in ("norm1", "norm2"):
            assert torch.equal(stacked["layers"][name][i], layer[name])
    rshapes = jax.eval_shape(build_model(rqwen.smoke()).init,
                             jax.random.PRNGKey(0))
    assert [tuple(x.shape) for x in tree.tree_leaves(stacked)] == \
        [x.shape for x in jax.tree.leaves(rshapes)]


# ---------------------------------------------------------------------------
# the round-trip property
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st

    _dtypes = st.sampled_from(["float32", "bfloat16", "float16"])
    _shapes = st.lists(st.integers(1, 4), min_size=0, max_size=3)

    @given(leaves=st.lists(st.tuples(_shapes, _dtypes),
                           min_size=1, max_size=6),
           m=st.integers(1, 5), lead=st.integers(0, 2), data=st.data())
    @settings(max_examples=40, deadline=None)
    def test_roundtrip_property(leaves, m, lead, data):
        """pack -> unpack is a bitwise round trip for arbitrary ragged
        trees, block counts and leading batch axes, and the packed table
        is the reference's. Scalar leaves are built with
        ``np.asarray(r.randn(*shape), np.float32)``: ``r.randn()`` with
        no shape returns a Python float."""
        r = np.random.RandomState(data.draw(st.integers(0, 2**31 - 1)))
        prefix = tuple(data.draw(st.integers(1, 3)) for _ in range(lead))
        tnp, dts = {}, {}
        for k, (shape, dt) in enumerate(leaves):
            tnp[f"l{k}"] = np.asarray(r.randn(*(prefix + tuple(shape))),
                                      np.float32)
            dts[f"/l{k}"] = dt
        tt, rt = _pair(tnp, dts)
        template = {k: torch.empty(tuple(v.shape[lead:]), dtype=v.dtype,
                                   device="meta") for k, v in tt.items()}
        layout = blocks.make_block_layout(template, num_blocks=m)
        rlayout = rblocks.make_block_layout(
            {k: jax.ShapeDtypeStruct(v.shape[lead:], v.dtype)
             for k, v in rt.items()}, num_blocks=m)
        _assert_same_layout(layout, rlayout)
        packed = layout.to_blocks(tt)
        assert packed.shape == prefix + (m, layout.block_dim)
        np.testing.assert_array_equal(_bits(packed),
                                      _bits(rlayout.to_blocks(rt)))
        back = layout.from_blocks(packed)
        for a, b in zip(tree.tree_leaves(tt), tree.tree_leaves(back)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(_bits(a), _bits(b))
        np.testing.assert_array_equal(
            packed.numpy()[..., ~layout.padding_mask()], 0.0)
except ImportError:                     # pragma: no cover - optional extra
    pass
