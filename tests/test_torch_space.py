"""Epoch parity: the port's flat epoch (``device="cpu"``, backend
``torch``) against the reference's ``jnp`` and ``pallas`` (interpret)
backends, over 20 epochs, at rtol = atol = 1e-5 — the tolerance the
reference holds between its own backends
(tests/test_backend_parity.py:22).

Torch cannot reproduce JAX's threefry draws, so every cell runs at
settings that draw nothing (``ConstantDelay``, ``cyclic`` over a full
edge set, ``gauss_southwell``) or with the draws injected into both
sides (``TraceDelay`` with a recorded delay matrix, and a callable
selector replaying a recorded selection). The unit tests below pin the
port's own draws: counts, ranges, determinism and tie-breaking.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ADMMConfig as RConfig
from repro.core import consensus as rcons
from repro.core import space as rspace
from repro_torch.configs.base import ADMMConfig
from repro_torch.core import async_sim, consensus, space
from repro_torch.data import make_sparse_logreg
from repro_torch.launch import mesh as tmesh

N, SAMPLES, DIM, M = 4, 32, 512, 8          # dblk = 128 > used_dim = 64
EPOCHS = 20
TOL = 1e-5
RHO_SCALE = np.array([0.5, 1.0, 2.0, 1.5], np.float32)
CFG = dict(rho=2.0, gamma=0.1, block_fraction=0.5, num_blocks=M,
           l1_coef=1e-3, clip=0.8, seed=0)

_rng = np.random.RandomState(11)
DELAYS = _rng.randint(0, 3, size=(EPOCHS, N, M))
SELS = _rng.rand(EPOCHS, N, M) < 0.5
CENTERS = _rng.randn(N, DIM).astype(np.float32)
SPARSE_EDGE = _rng.rand(N, M) < 0.7
SPARSE_EDGE[:, 0] = True                     # every worker keeps a block
DATA = make_sparse_logreg(N, SAMPLES, DIM, density=0.03, locality=0.95,
                          seed=3)


def _jax_logreg(z, d):
    X, y = d
    return jnp.mean(jnp.log1p(jnp.exp(-y * (X @ z))))


def _torch_logreg(z, d):
    X, y = d
    return torch.mean(torch.log1p(torch.exp(-y * (X @ z))))


def _jax_quad(z, c):
    return 0.5 * jnp.sum(jnp.square(z - c))


def _torch_quad(z, c):
    return 0.5 * torch.sum(torch.square(z - c))


def _problem_args(loss, edge):
    """(reference, port) make_problem arguments for one cell."""
    if loss == "logreg":
        data, ref_fn, port_fn = (DATA.X, DATA.y), _jax_logreg, _torch_logreg
    else:
        data, ref_fn, port_fn = CENTERS, _jax_quad, _torch_quad
    kw = dict(dim=DIM, num_blocks=M, l1_coef=CFG["l1_coef"],
              clip=CFG["clip"], rho_scale=RHO_SCALE)
    if edge == "support":
        kw["support"] = DATA.support
    elif edge == "sparse":
        kw["edge"] = SPARSE_EDGE
    ref_data = jax.tree.map(jnp.asarray, data)
    return (ref_fn, ref_data, kw), (port_fn, data, kw)


def _policies(selector, delay):
    """(reference, port) (selector, delay_model) with identical draws."""
    if delay == "trace":
        dms = rspace.TraceDelay(DELAYS), space.TraceDelay(DELAYS)
    else:
        dms = rspace.ConstantDelay(1), space.ConstantDelay(1)
    if selector == "injected":
        sels_j, sels_t = jnp.asarray(SELS), torch.as_tensor(SELS)
        sels = ((lambda ctx: sels_j[ctx.t] & ctx.edge),
                (lambda ctx: sels_t[ctx.t] & ctx.edge))
    else:
        sels = selector, selector
    return (sels[0], dms[0]), (sels[1], dms[1])


def _leaves(state, track_x):
    names = ("z_hist", "y", "w_cache") + (("x",) if track_x else ())
    return {k: np.asarray(getattr(state, k)) for k in names}


CELLS = [
    # loss,    selector,          delay,      track_x, edge set
    ("logreg", "gauss_southwell", "trace",    True,  "support"),
    ("logreg", "injected",        "trace",    False, "support"),
    ("logreg", "cyclic",          "constant", True,  "full"),
    ("quad",   "gauss_southwell", "constant", False, "sparse"),
    ("quad",   "injected",        "constant", True,  "sparse"),
    ("quad",   "cyclic",          "trace",    False, "full"),
]


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("loss,selector,delay,track_x,edge", CELLS)
def test_epoch_parity_with_reference(loss, selector, delay, track_x, edge,
                                     backend):
    (rfn, rdata, rkw), (tfn, tdata, tkw) = _problem_args(loss, edge)
    (rsel, rdm), (tsel, tdm) = _policies(selector, delay)
    rprob = rcons.make_problem(rfn, rdata, **rkw)
    rspec = rprob.spec(RConfig(**CFG), selector=rsel, delay_model=rdm,
                       backend=backend, track_x=track_x)
    tprob = consensus.make_problem(tfn, tdata, device="cpu", **tkw)
    tspec = tprob.spec(ADMMConfig(**CFG), selector=tsel, delay_model=tdm,
                       track_x=track_x)
    assert tspec.space.backend == "torch"
    np.testing.assert_array_equal(tspec.edge.numpy(), np.asarray(rspec.edge))

    rstep = jax.jit(lambda s: rspace.asybadmm_epoch(rspec, s, rprob.data))
    rstate = rspace.init_consensus_state(rspec)
    tstate = space.init_consensus_state(tspec)
    for t in range(EPOCHS):
        rstate, rinfo = rstep(rstate)
        tstate, tinfo = space.asybadmm_epoch(tspec, tstate, tprob.data)
        np.testing.assert_allclose(
            tprob.blocks.from_blocks(tstate.z_blocks).numpy(),
            np.asarray(rprob.blocks.from_blocks(rstate.z_blocks)),
            rtol=TOL, atol=TOL, err_msg=f"z diverged at epoch {t}")
        np.testing.assert_allclose(float(tinfo["loss"]),
                                   float(rinfo["loss"]), rtol=TOL, atol=TOL)
        assert float(tinfo["selected_fraction"]) == \
            float(rinfo["selected_fraction"])
    for k, v in _leaves(rstate, track_x).items():
        np.testing.assert_allclose(_leaves(tstate, track_x)[k], v,
                                   rtol=TOL, atol=TOL, err_msg=k)
    assert tstate.t == int(rstate.t) == EPOCHS
    assert (tstate.x is None) == (not track_x)
    assert float(np.abs(np.asarray(rstate.z_hist[0])).max()) > 0.0


# ---------------------------------------------------------------------------
# the port's own draws and dispatch
# ---------------------------------------------------------------------------

def _ctx(edge, t=0, frac=0.5, gnorm=None, seed=0):
    return space.SelectorContext(
        rng=torch.Generator().manual_seed(seed), edge=edge, t=t,
        block_fraction=frac, grad_sqnorm=lambda: gnorm)


def test_gauss_southwell_breaks_ties_toward_lower_index():
    edge = torch.ones((3, 6), dtype=torch.bool)
    edge[2, :2] = False
    gnorm = torch.tensor([[1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                          [0.0, 2.0, 2.0, 5.0, 2.0, 2.0],
                          [9.0, 9.0, 1.0, 1.0, 1.0, 1.0]])
    sel = space.gauss_southwell_selector(_ctx(edge, gnorm=gnorm))
    expect = torch.tensor([[1, 1, 1, 0, 0, 0],
                           [0, 1, 1, 1, 0, 0],
                           [0, 0, 1, 1, 1, 0]], dtype=torch.bool)
    assert torch.equal(sel, expect)


@pytest.mark.parametrize("name", ["random", "zipf"])
def test_random_selectors_pick_k_blocks_in_the_edge_set(name):
    edge = torch.as_tensor(np.random.RandomState(0).rand(5, 10) < 0.6)
    edge[:, 0] = True
    sel = space.BLOCK_SELECTORS[name](_ctx(edge, frac=0.3))
    assert not bool((sel & ~edge).any())
    assert sel.sum(1).tolist() == torch.clamp_max(edge.sum(1), 3).tolist()
    assert torch.equal(sel, space.BLOCK_SELECTORS[name](_ctx(edge, frac=0.3)))
    assert not torch.equal(
        sel, space.BLOCK_SELECTORS[name](_ctx(edge, frac=0.3, seed=1)))


def test_cyclic_selector_sweeps_and_falls_back():
    edge = torch.ones((2, 4), dtype=torch.bool)
    edge[1, 2] = False
    sel = space.cyclic_selector(_ctx(edge, t=6, frac=1.0))
    assert sel[0].tolist() == [False, False, True, False]
    assert torch.equal(sel[1], edge[1])      # block 2 missing: fallback


def test_delay_models_draw_in_range():
    gen = torch.Generator().manual_seed(0)
    d = space.UniformDelay(3).sample(gen, 4, 6)
    assert d.dtype == torch.int64 and d.shape == (4, 6)
    assert 0 <= int(d.min()) and int(d.max()) <= 3
    assert bool((space.ConstantDelay(2).sample(gen, 4, 6) == 2).all())
    p = space.ParetoDelay(4, alpha=1.2).sample(gen, 40, 60)
    assert 0 <= int(p.min()) and int(p.max()) <= 4
    assert space.ParetoDelay(0).sample(gen, 2, 3).abs().sum() == 0
    assert space.sample_delay_model(space.ConstantDelay(1), gen, 2, 3,
                                    t=0).shape == (2, 3)


def test_trace_delay_clamps_and_masks_participation():
    delays = np.arange(2 * 2 * 3).reshape(2, 2, 3) % 3
    part = np.array([[True, False], [True, True]])
    dm = space.TraceDelay(np.where(part[:, :, None], delays, -1), part)
    gen = torch.Generator()
    assert dm.depth == 3 and dm.num_rounds == 2
    assert dm.sample(gen, 2, 3, t=0)[1].tolist() == [0, 0, 0]
    assert torch.equal(dm.sample(gen, 2, 3, t=9),
                       torch.as_tensor(delays[1]))
    assert dm.participation_mask(0, "cpu").flatten().tolist() == [True, False]
    with pytest.raises(ValueError, match="negative"):
        space.TraceDelay(-np.ones((1, 2, 3)))
    with pytest.raises(ValueError, match="recorded for"):
        dm.sample(gen, 3, 3, t=0)
    with pytest.raises(ValueError, match="epoch counter"):
        dm.sample(gen, 2, 3)


def test_resolve_backend_and_unported_options():
    assert space.resolve_backend(None, "cpu") == "torch"
    assert space.resolve_backend("auto", "cuda") == "cuda"
    assert space.resolve_backend("torch", "cuda") == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        space.resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        space.resolve_backend("pallas", "cpu")
    prob = consensus.make_problem(_torch_quad, CENTERS, DIM, M, device="cpu")
    # the SPMD epoch needs a process group: a mesh without one is an
    # error, never a quiet single-device run
    with pytest.raises(RuntimeError, match="process group"):
        prob.spec(ADMMConfig(**CFG), mesh="test")
    with pytest.raises(RuntimeError, match="process group"):
        prob.spec(dataclasses.replace(ADMMConfig(**CFG), mesh="pod"))
    assert prob.spec(ADMMConfig(**CFG), mesh="none").space.mesh is None
    with pytest.raises(RuntimeError, match="process group"):
        consensus.make_problem(_torch_quad, CENTERS, DIM, M, mesh="test",
                               device="cpu")
    # bad mesh shapes and names are ValueErrors, before any group is asked
    with pytest.raises(ValueError, match="divide"):
        tmesh.make_test_mesh(8, 3)
    with pytest.raises(ValueError, match="unknown mesh"):
        tmesh.resolve_mesh("ring")
    assert tmesh.resolve_mesh(None) is None
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        prob.spec(dataclasses.replace(ADMMConfig(**CFG), autotune="cached"))
    with pytest.raises(ValueError, match="cuda"):
        prob.spec(ADMMConfig(**CFG), backend="cuda")


def test_epoch_draws_follow_seed_and_epoch():
    """Same (seed, t) -> same draws -> same trajectory; another seed moves
    the random policies."""
    def run(seed):
        prob = consensus.make_problem(_torch_quad, CENTERS, DIM, M,
                                      l1_coef=1e-3, clip=0.8, device="cpu")
        cfg = dataclasses.replace(ADMMConfig(**CFG), seed=seed, max_delay=2)
        spec = prob.spec(cfg, minibatch=None)
        state = space.init_consensus_state(spec)
        for _ in range(4):
            state, _ = space.asybadmm_epoch(spec, state, prob.data)
        return state.z_blocks
    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))


def test_minibatch_subsamples_rows_deterministically():
    prob = consensus.make_problem(_torch_logreg, (DATA.X, DATA.y), DIM, M,
                                  device="cpu")
    with pytest.raises(ValueError, match="minibatch"):
        prob.spec(ADMMConfig(**CFG), minibatch=1.5)
    spec = prob.spec(ADMMConfig(**CFG), minibatch=0.25)
    assert spec.minibatch == 0.25
    assert prob.spec(ADMMConfig(**CFG), minibatch=1.0).minibatch is None
    state = space.init_consensus_state(spec)
    a, _ = space.asybadmm_epoch(spec, state, prob.data)
    b, _ = space.asybadmm_epoch(spec, state, prob.data)
    assert torch.equal(a.z_blocks, b.z_blocks)
    gen = torch.Generator().manual_seed(0)
    X, y = async_sim.subsample_worker_data(gen, prob.data, 0.25)
    assert X.shape == (N, SAMPLES // 4, DIM) and y.shape == (N, SAMPLES // 4)


def test_watchdog_names_the_diverged_blocks():
    prob = consensus.make_problem(_torch_quad, CENTERS, DIM, M, device="cpu")
    spec = prob.spec(dataclasses.replace(ADMMConfig(**CFG),
                                         block_fraction=1.0))
    state = space.init_consensus_state(spec)
    bad = torch.as_tensor(CENTERS).clone()
    bad[:, 3 * 64] = float("nan")                  # block 3's first coord
    prev = space.set_epoch_check_finite(True)
    try:
        with pytest.raises(FloatingPointError, match=r"block\(s\) \[3\]"):
            space.asybadmm_epoch(spec, state, bad)
    finally:
        space.set_epoch_check_finite(prev)
    assert space.consensus_residual(spec, state) >= 0
