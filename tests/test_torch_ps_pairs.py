"""One small PS-runtime problem built in both packages, for the port's
parity tests (``test_torch_ps_*.py``).

``sessions`` builds the reference's and the port's ``ConsensusSession``
on the same config and data. The reference draws its block selections
and minibatches from JAX's threefry, which torch cannot reproduce, so
``inject_selection`` / ``inject_minibatch`` patch the port's
``SpaceEngine`` to serve the reference engine's draws for each round
(the way ``tests/test_torch_examples.py`` injects the epoch's draws);
draw-free configs (cyclic selection over a full edge set,
Gauss-Southwell) need neither. Everything else — service-time draws,
fault timelines, transport decisions — is numpy on both sides and must
come out identical.

``sessions(tree=True)`` builds pytree sessions instead: one leaf
``w{j}`` per block, pinned to block j, the same quadratic loss over
their concatenation; their runs take the centers from ``batches``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro import api as rapi
from repro import ps as rps
from repro.configs.base import ADMMConfig as RConfig
from repro.core.blocks import TreeBlocks as RTreeBlocks
from repro_torch import api as tapi
from repro_torch import ps as tps
from repro_torch.configs.base import ADMMConfig as TConfig
from repro_torch.core import tree as ttree
from repro_torch.core.blocks import TreeBlocks

N, M, DBLK = 3, 4, 5
DIM = M * DBLK
ROUNDS = 6
TOL = dict(rtol=1e-5, atol=1e-6)       # tests/test_ps_runtime.py:97

_r = np.random.RandomState(7)
CENTERS = _r.randn(N, DIM).astype(np.float32)
EDGE = np.array([[1, 1, 0, 1],
                 [1, 0, 1, 0],
                 [1, 1, 1, 1]], bool)
RHO_SCALE = np.array([0.5, 1.0, 2.0], np.float32)
_x = np.random.RandomState(3)
LOGREG = (_x.randn(N, 24, DIM).astype(np.float32),
          np.sign(_x.randn(N, 24)).astype(np.float32))


def cfg_kw(selection="random", max_delay=2, num_blocks=M, **kw):
    return dict(rho=2.0, gamma=0.1, max_delay=max_delay, block_fraction=0.5,
                num_blocks=num_blocks, block_selection=selection,
                l1_coef=1e-3, clip=0.8, seed=0, **kw)


def _tree_sessions(r_loss, t_loss, c, ckw, extra, delay_models):
    """Pytree sessions of leaves w0..w{M-1}, leaf j pinned to block j."""
    M_ = ckw["num_blocks"]
    dblk = c.shape[1] // M_
    rparams = {f"w{j}": jnp.zeros(dblk, jnp.float32) for j in range(M_)}
    tparams = {f"w{j}": torch.zeros(dblk) for j in range(M_)}
    ids = tuple(range(M_))
    rb = RTreeBlocks(num_blocks=M_, leaf_block_ids=ids,
                     treedef=jax.tree.structure(rparams))
    tb = TreeBlocks(num_blocks=M_, leaf_block_ids=ids,
                    treedef=ttree.tree_structure(tparams))
    ref = rapi.ConsensusSession.pytree(
        lambda p, cc: r_loss(jnp.concatenate(
            [p[f"w{j}"] for j in range(M_)]), cc),
        rparams, RConfig(**ckw), num_workers=c.shape[0], blocks=rb,
        delay_model=delay_models[0], **extra)
    port = tapi.ConsensusSession.pytree(
        lambda p, cc: t_loss(torch.cat([p[f"w{j}"] for j in range(M_)]), cc),
        tparams, TConfig(**ckw), num_workers=c.shape[0], blocks=tb,
        delay_model=delay_models[1], device="cpu", **extra)
    return ref, port


def batches(centers=None):
    """(reference, port) ``batches`` callables of a tree run."""
    c = CENTERS if centers is None else centers
    rc, tc = jnp.asarray(c), torch.as_tensor(c)
    return (lambda t: rc), (lambda t: tc)


def sessions(selection="random", *, edge=EDGE, logreg=False, centers=None,
             delay_models=(None, None), tree=False, **kw):
    """(reference session, port session) on the CPU: the quadratic loss
    around ``centers`` (or the logistic loss on ``LOGREG``); pytree
    sessions of the quadratic loss with ``tree=True``."""
    c = CENTERS if centers is None else centers
    dim = LOGREG[0].shape[2] if logreg else c.shape[1]
    ckw = cfg_kw(selection, **kw)
    extra = {} if edge is None else dict(edge=edge, rho_scale=RHO_SCALE)
    if logreg:
        r_loss = lambda z, d: jnp.mean(jnp.log1p(jnp.exp(-d[1] * (d[0] @ z))))
        t_loss = lambda z, d: torch.mean(torch.log1p(torch.exp(
            -d[1] * (d[0] @ z))))
        r_data = tuple(jnp.asarray(a) for a in LOGREG)
        t_data = tuple(torch.as_tensor(a) for a in LOGREG)
    else:
        r_loss = lambda z, cc: 0.5 * jnp.sum(jnp.square(z - cc))
        t_loss = lambda z, cc: 0.5 * torch.sum(torch.square(z - cc))
        r_data, t_data = jnp.asarray(c), torch.as_tensor(c)
    if tree:
        return _tree_sessions(r_loss, t_loss, c, ckw, extra, delay_models)
    ref = rapi.ConsensusSession.flat(r_loss, r_data, dim=dim,
                                     cfg=RConfig(**ckw),
                                     delay_model=delay_models[0], **extra)
    port = tapi.ConsensusSession.flat(t_loss, t_data, dim=dim,
                                      cfg=TConfig(**ckw),
                                      delay_model=delay_models[1],
                                      device="cpu", **extra)
    return ref, port


def inject_selection(monkeypatch, ref_sess):
    """The port's engine serves the reference engine's round-t
    selection (gradient-free selectors only)."""
    ref_eng = rps.SpaceEngine(ref_sess.spec)

    def select_full(self, t, gnorm_row, i):
        assert gnorm_row is None, "inject only gradient-free selectors"
        return np.asarray(ref_eng._select_full(t, None, 0), bool)

    monkeypatch.setattr(tps.SpaceEngine, "_select_full", select_full)


def inject_minibatch(monkeypatch, ref_sess):
    """The port's engine serves the reference engine's round-t
    minibatch."""
    ref_eng = rps.SpaceEngine(ref_sess.spec)

    def round_data(self, t, data):
        sub = ref_eng.round_data(t, ref_sess.data)
        return pytree.tree_map(lambda a: torch.tensor(np.asarray(a)),
                               tuple(sub))

    monkeypatch.setattr(tps.SpaceEngine, "round_data", round_data)


def timings(kind):
    """The same cost profile in each package's classes."""
    out = []
    for ps in (rps, tps):
        if kind == "constant":
            t = ps.CostProfile(t_worker=ps.ConstantService(1.0),
                               t_server_block=ps.ConstantService(0.25))
        elif kind == "lognormal":
            t = ps.CostProfile(t_worker=ps.LognormalService(1.0, 0.3),
                               t_server_block=ps.LognormalService(0.25, 0.15))
        elif kind == "pareto":
            t = ps.CostProfile(t_worker=ps.ParetoService(1.0, alpha=1.2),
                               t_server_block=ps.LognormalService(0.3, 0.4))
        elif kind == "net":
            t = ps.CostProfile(t_worker=ps.ConstantService(1.0),
                               t_server_block=ps.ConstantService(0.25),
                               net=ps.NetworkModel(0.5, 0.2))
        else:
            raise ValueError(kind)
        out.append(t)
    return tuple(out)


def assert_same_schedule(ref_res, port_res):
    """What the runtime's clock decided: bitwise equal."""
    assert port_res.makespan == ref_res.makespan
    np.testing.assert_array_equal(port_res.trace.delays, ref_res.trace.delays)
    if ref_res.trace.participation is None:
        assert port_res.trace.participation is None
    else:
        np.testing.assert_array_equal(port_res.trace.participation,
                                      ref_res.trace.participation)
    assert port_res.trace.events == ref_res.trace.events
    assert port_res.trace.transport == ref_res.trace.transport
    assert port_res.metrics["histograms"] == ref_res.metrics["histograms"]
    assert port_res.metrics == ref_res.metrics


def vec(z) -> np.ndarray:
    """A flat z, or a tree's leaves in sorted-key order, as one vector."""
    if isinstance(z, dict):
        return np.concatenate([np.asarray(z[k]).ravel() for k in sorted(z)])
    return np.asarray(z)


def assert_same_z(ref_res, port_res):
    assert len(port_res.z_versions) == len(ref_res.z_versions)
    for v, (a, b) in enumerate(zip(ref_res.z_versions, port_res.z_versions)):
        assert isinstance(b, dict) == isinstance(a, dict)
        np.testing.assert_allclose(vec(b), vec(a), err_msg=f"version {v}",
                                   **TOL)
    if ref_res.losses is not None:
        np.testing.assert_allclose(port_res.losses, ref_res.losses, **TOL)


def assert_replays(res, sess, to_numpy=vec, batch=None):
    """``res``'s trace through ``sess``'s epoch (on ``batch``, a tree
    session's data) gives ``res``'s z."""
    state = sess.init()
    for t in range(res.num_rounds):
        state, _ = sess.step(state, batch)
        np.testing.assert_allclose(
            to_numpy(sess.z(state)), to_numpy(res.z_versions[t + 1]),
            err_msg=f"replay diverged at round {t}", **TOL)
