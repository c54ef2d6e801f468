"""Pytree mode in the port: ``TreeSpace`` and ``ConsensusSession.pytree``
(``device="cpu"``, backend ``torch``).

(a) tests/test_space_parity.py in the port: the same quadratic
    consensus problem through ``FlatSpace`` and ``TreeSpace`` gives the
    same z trajectory (1e-6) for random, cyclic and Gauss-Southwell
    selection under bounded delay, heterogeneous rho_i and a sparse edge
    set (both spaces draw from the same ``(seed, t, stream)``
    generators); the edge set is respected; rho_scale is honoured;
(b) the port's tree epoch against the reference's
    ``ConsensusSession.pytree`` on its ``jnp`` backend for 10 epochs at
    1e-5, LPT blocks over a ragged tree, for all three selectors. Torch
    cannot reproduce JAX's threefry draws, so the reference's delays
    (and, for ``random``, its selections) are taken from its own key
    chain (``epoch_keys``) and replayed in the port; cyclic over a full
    edge set and Gauss-Southwell select without drawing. One case holds
    a bf16 leaf, at the reference's bf16 tolerance;
(c) the session's pytree surface: z in stored dtypes, the gradient of
    bf16 leaves packed to f32, a loss that writes its params in place
    refused, the flat-only measures refused, a run continued from the
    reference's state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ConsensusSession as RSession
from repro.configs.base import ADMMConfig as RConfig
from repro.core import space as rspace
from repro_torch.api import ConsensusSession
from repro_torch.configs.base import ADMMConfig
from repro_torch.core import space, tree
from repro_torch.core.blocks import TreeBlocks

N, M, DBLK = 3, 4, 5
DIM = M * DBLK
EPOCHS = 10
TOL = 1e-5
BF16_TOL = 4e-2                    # tests/test_kernels.py:37

# every worker keeps >= 1 block; block 0 is shared by all
EDGE = np.array([[1, 1, 0, 1],
                 [1, 0, 1, 0],
                 [1, 1, 1, 1]], bool)
RHO_SCALE = np.array([0.5, 1.0, 2.0], np.float32)
CENTERS = np.random.RandomState(7).randn(N, DIM).astype(np.float32)


def _cfg(scheme="random", cls=ADMMConfig, **kw):
    base = dict(rho=2.0, gamma=0.1, max_delay=1, block_fraction=0.5,
                num_blocks=M, block_selection=scheme, l1_coef=1e-3, seed=0)
    return cls(**{**base, **kw})


# ---------------------------------------------------------------------------
# (a) flat <-> tree in the port
# ---------------------------------------------------------------------------

def _flat_loss(z, c):
    return 0.5 * torch.sum(torch.square(z - c))


def _tree_params():
    return {f"w{j}": torch.zeros(DBLK) for j in range(M)}


def _tree_loss(p, c):
    z = torch.cat([p[f"w{j}"] for j in range(M)])
    return 0.5 * torch.sum(torch.square(z - c))


def _tree_vec(z):
    return torch.cat([z[f"w{j}"] for j in range(M)]).numpy()


def _pinned_blocks(params):
    """Leaf k of the sorted dict IS flat block k."""
    return TreeBlocks(num_blocks=M, leaf_block_ids=tuple(range(M)),
                      treedef=tree.tree_structure(params))


@pytest.mark.parametrize("scheme", ["random", "cyclic", "gauss_southwell"])
def test_flat_tree_same_z_trajectory(scheme):
    cfg = _cfg(scheme)
    centers = torch.as_tensor(CENTERS)
    flat = ConsensusSession.flat(_flat_loss, centers, dim=DIM, cfg=cfg,
                                 edge=EDGE, rho_scale=RHO_SCALE,
                                 device="cpu")
    params = _tree_params()
    tr = ConsensusSession.pytree(_tree_loss, params, cfg, num_workers=N,
                                 blocks=_pinned_blocks(params), edge=EDGE,
                                 rho_scale=RHO_SCALE, device="cpu")
    assert isinstance(tr.spec.space, space.TreeSpace)
    sf, st = flat.init(), tr.init()
    for t in range(25):
        sf, info_f = flat.step(sf)
        st, info_t = tr.step(st, centers)
        np.testing.assert_allclose(flat.z(sf).numpy(), _tree_vec(tr.z(st)),
                                   rtol=1e-6, atol=1e-6,
                                   err_msg=f"{scheme} diverged at epoch {t}")
        assert float(info_f["selected_fraction"]) == \
            float(info_t["selected_fraction"])
    assert float(flat.z(sf).abs().max()) > 0.0


def test_pytree_edge_set_respected():
    """Workers never touch blocks outside their edge neighborhood: the
    duals y of a (worker, block) pair outside E stay exactly zero."""
    params = _tree_params()
    sess = ConsensusSession.pytree(
        _tree_loss, params, _cfg(block_fraction=1.0, seed=1), num_workers=N,
        blocks=_pinned_blocks(params), edge=EDGE, device="cpu")
    state = sess.init()
    for _ in range(5):
        state, _ = sess.step(state, torch.as_tensor(CENTERS))
    y = state.y.numpy()
    for j in range(M):
        assert np.all(y[~EDGE[:, j], j] == 0.0), (j, y)
        assert np.any(y[EDGE[:, j], j] != 0.0), (j, y)


def test_pytree_heterogeneous_rho_changes_trajectory():
    params = _tree_params()

    def final_z(rho_scale):
        sess = ConsensusSession.pytree(
            _tree_loss, params, _cfg(max_delay=0, block_fraction=1.0),
            num_workers=N, blocks=_pinned_blocks(params),
            rho_scale=rho_scale, device="cpu")
        state = sess.init()
        for _ in range(10):
            state, _ = sess.step(state, torch.as_tensor(CENTERS))
        return _tree_vec(sess.z(state))

    z_homog, z_heterog = final_z(None), final_z(RHO_SCALE)
    assert np.isfinite(z_homog).all() and np.isfinite(z_heterog).all()
    assert float(np.max(np.abs(z_homog - z_heterog))) > 1e-4


# ---------------------------------------------------------------------------
# (b) the port's tree epoch against the reference's
# ---------------------------------------------------------------------------

LEAVES = {"emb": (6, 5), "bias": (3,), "scale": (), "deep/w": (4, 4),
          "deep/v": (7,)}


def _ragged(dtypes=None):
    """(port params, reference params, port loss, reference loss, batch):
    a ragged tree whose LPT assignment over M = 4 leaves padding, and the
    quadratic loss around per-worker centers of the packed length."""
    dtypes = dtypes or {}
    r = np.random.RandomState(5)
    vals = {n: np.asarray(r.randn(*s) * 0.1, np.float32)
            for n, s in LEAVES.items()}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

    def build(leaf):
        return {"emb": leaf("emb"), "bias": leaf("bias"),
                "scale": leaf("scale"),
                "deep": {"w": leaf("deep/w"), "v": leaf("deep/v")}}
    tparams = build(lambda n: torch.as_tensor(vals[n]).to(
        tdt[dtypes.get(n, "float32")]))
    rparams = build(lambda n: jnp.asarray(vals[n]).astype(
        jdt[dtypes.get(n, "float32")]))
    size = sum(a.size for a in vals.values())
    batch = np.random.RandomState(6).randn(N, size).astype(np.float32)

    def tloss(p, c):
        z = torch.cat([x.reshape(-1) for x in tree.tree_leaves(p)])
        return 0.5 * torch.sum(torch.square(z - c))

    def rloss(p, c):
        z = jnp.concatenate([x.reshape(-1) for x in jax.tree.leaves(p)])
        return 0.5 * jnp.sum(jnp.square(z - c))
    return tparams, rparams, tloss, rloss, batch


def _reference_draws(scheme, edge, max_delay=1, epochs=EPOCHS):
    """The delays, and for ``random`` the selections, the reference's own
    epoch draws: its per-epoch key split, delay model and selector."""
    rng = jax.random.PRNGKey(0)
    delays, sels = [], []
    for t in range(epochs):
        rng, r_delay, r_sel, _ = rspace.epoch_keys(rng, None)
        delays.append(np.asarray(rspace.sample_delay_model(
            rspace.UniformDelay(max_delay), r_delay, N, M, t)))
        ctx = rspace.SelectorContext(
            rng=r_sel, edge=jnp.asarray(edge), t=jnp.int32(t),
            block_fraction=0.5, grad_sqnorm=None)
        if scheme == "random":
            sels.append(np.asarray(rspace.BLOCK_SELECTORS["random"](ctx)))
    return np.stack(delays), (np.stack(sels) if sels else None)


def _pair_sessions(scheme, edge, dtypes=None):
    tparams, rparams, tloss, rloss, batch = _ragged(dtypes)
    rsess = RSession.pytree(rloss, rparams, _cfg(scheme, RConfig),
                            num_workers=N, edge=edge, rho_scale=RHO_SCALE,
                            backend="jnp")
    delays, sels = _reference_draws(scheme, edge)
    sel = None
    if sels is not None:
        sels_t = torch.as_tensor(sels)
        sel = lambda ctx: sels_t[ctx.t] & ctx.edge    # noqa: E731
    tsess = ConsensusSession.pytree(tloss, tparams, _cfg(scheme),
                                    num_workers=N, edge=edge,
                                    rho_scale=RHO_SCALE,
                                    delay_model=space.TraceDelay(delays),
                                    selector=sel, device="cpu")
    return rsess, tsess, batch


@pytest.mark.parametrize("scheme,edge", [
    ("random", EDGE), ("cyclic", np.ones((N, M), bool)),
    ("gauss_southwell", EDGE)])
def test_tree_epoch_matches_reference(scheme, edge):
    rsess, tsess, batch = _pair_sessions(scheme, edge)
    rl, tl = rsess.spec.space.layout, tsess.spec.space.layout
    assert tl.block_ids == rl.block_ids and tl.block_dim == rl.block_dim
    assert sum(tl.block_sizes) < M * tl.block_dim          # rows are padded
    rstep = rsess.step_fn()
    rs, ts = rsess.init(), tsess.init()
    for t in range(EPOCHS):
        rs, rinfo = rstep(rs, jnp.asarray(batch))
        ts, tinfo = tsess.step(ts, torch.as_tensor(batch))
        np.testing.assert_allclose(ts.z_blocks.numpy(),
                                   np.asarray(rs.z_hist[0]), rtol=TOL,
                                   atol=TOL, err_msg=f"z diverged at {t}")
        np.testing.assert_allclose(ts.w_cache.numpy(), np.asarray(rs.w_cache),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(tinfo["loss"]), float(rinfo["loss"]),
                                   rtol=TOL, atol=TOL)
        assert float(tinfo["selected_fraction"]) == \
            float(rinfo["selected_fraction"])
    for a, b in zip(tree.tree_leaves(tsess.z(ts)),
                    jax.tree.leaves(rsess.z(rs))):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(tsess.consensus_residual(ts),
                               rsess.consensus_residual(rs), rtol=TOL,
                               atol=TOL)
    assert float(ts.z_blocks.abs().max()) > 0.0


def test_tree_epoch_with_a_bf16_leaf_matches_reference():
    """A bf16 leaf: the loss sees it in bf16 in both packages, its
    gradient is bf16 and packs to f32; held at the reference's bf16
    tolerance."""
    rsess, tsess, batch = _pair_sessions("gauss_southwell", EDGE,
                                         {"emb": "bfloat16"})
    assert tsess.spec.space.layout.leaf_dtypes == \
        rsess.spec.space.layout.leaf_dtypes
    rs, ts = rsess.init(), tsess.init()
    np.testing.assert_array_equal(ts.z_blocks.numpy(), np.asarray(rs.z_hist[0]))
    rstep = rsess.step_fn()
    for t in range(EPOCHS):
        rs, _ = rstep(rs, jnp.asarray(batch))
        ts, _ = tsess.step(ts, torch.as_tensor(batch))
        np.testing.assert_allclose(ts.z_blocks.numpy(),
                                   np.asarray(rs.z_hist[0]), rtol=BF16_TOL,
                                   atol=BF16_TOL, err_msg=f"epoch {t}")
    z = tsess.z(ts)
    assert z["emb"].dtype == torch.bfloat16
    assert z["deep"]["w"].dtype == torch.float32


def test_run_started_in_jax_continues_in_the_port():
    """``state_from_numpy`` takes the reference's tree state after 4
    epochs; 4 more in the port follow the reference's epochs 5-8."""
    rsess, tsess, batch = _pair_sessions("cyclic", np.ones((N, M), bool))
    rstep = rsess.step_fn()
    rs = rsess.init()
    for _ in range(4):
        rs, _ = rstep(rs, jnp.asarray(batch))
    ts = space.state_from_numpy(
        {k: np.asarray(v) for k, v in rs._asdict().items()}, tsess.spec,
        device="cpu")
    assert ts.t == 4 and ts.x is None
    for t in range(4):
        rs, _ = rstep(rs, jnp.asarray(batch))
        ts, _ = tsess.step(ts, torch.as_tensor(batch))
        np.testing.assert_allclose(ts.z_blocks.numpy(),
                                   np.asarray(rs.z_hist[0]), rtol=TOL,
                                   atol=TOL)


# ---------------------------------------------------------------------------
# (c) the pytree surface
# ---------------------------------------------------------------------------

def test_worker_grads_on_a_tree_of_leaves():
    """``worker_grads`` differentiates every leaf with its leading N:
    bf16 leaves give bf16 gradients, packed to the f32 table; a tree with
    ``None`` nodes runs; a loss writing its params in place is refused
    and leaves z~ as it was."""
    params = {"a": torch.zeros(3), "h": torch.zeros(2, dtype=torch.bfloat16),
              "none": None}
    sess = ConsensusSession.pytree(
        lambda p, c: 0.5 * torch.sum(torch.square(p["a"] - c))
        + torch.sum(p["h"].float() * c[0]),
        params, _cfg(num_blocks=2), num_workers=2, device="cpu")
    sp, layout = sess.spec.space, sess.spec.space.layout
    z = torch.randn((2, 2, layout.block_dim))
    z[..., ~torch.as_tensor(layout.padding_mask())] = 0.0
    c = torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    losses, g = sp.worker_grads(sess.spec.loss_fn, z, c)
    assert losses.shape == (2,) and g.dtype == torch.float32
    user = layout.from_blocks(z)
    gt = layout.from_blocks(g)
    assert gt["h"].dtype == torch.bfloat16 and gt["none"] is None
    torch.testing.assert_close(gt["a"], user["a"] - c, rtol=0, atol=1e-6)
    torch.testing.assert_close(
        gt["h"], c[:, :1].expand(2, 2).to(torch.bfloat16), rtol=0, atol=0)
    np.testing.assert_array_equal(
        g.numpy()[..., ~layout.padding_mask()], 0.0)

    def in_place(p, c):
        p["a"].mul_(2.0)
        return torch.sum(p["a"])
    before = z.clone()
    with pytest.raises(RuntimeError, match="in-place"):
        sp.worker_grads(in_place, z, c)
    assert torch.equal(z, before)


def test_pytree_session_surface():
    tparams, _, tloss, _, batch = _ragged({"emb": "bfloat16"})
    sess = ConsensusSession.pytree(tloss, tparams, _cfg(), num_workers=N,
                                   device="cpu")
    assert sess.problem is None and sess.data is None
    assert sess.spec.track_x is False and sess.spec.space.backend == "torch"
    state = sess.init()
    assert state.x is None
    z0 = sess.z(state)
    for a, b in zip(tree.tree_leaves(z0), tree.tree_leaves(tparams)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    state, hist = sess.run(4, batches=lambda t: torch.as_tensor(batch),
                           eval_every=2)
    assert [sorted(h) for h in hist] == [["epoch", "loss"]] * 2
    for name in ("objective", "stationarity", "kkt_violations"):
        with pytest.raises(ValueError, match="flat mode"):
            getattr(sess, name)(state)
    assert sess.consensus_residual(state) >= 0.0
    with pytest.raises(ValueError, match="initial params"):
        sess.spec.space.init_repr(None, "cpu")
    bare = space.TreeSpace(blocks=sess.spec.space.blocks, num_workers=N)
    with pytest.raises(ValueError, match="BlockLayout"):
        bare.packer
    with pytest.raises(ValueError, match="cuda"):
        ConsensusSession.pytree(tloss, tparams, _cfg(), num_workers=N,
                                backend="cuda", device="cpu")


def test_pytree_session_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConsensusSession.pytree(_tree_loss, _tree_params(), _cfg(),
                                num_workers=N)
