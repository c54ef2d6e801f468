"""The port's user surface (``repro_torch.api``) against the reference's:
``ConsensusSession.flat(...).run``, ``solve``, the objective, the
stationarity measure P (eqs. 14-15), the KKT violations, and a run
started in JAX and continued in the port (``state_from_numpy``).
Draw-free policies (``gauss_southwell``, ``ConstantDelay``) or recorded
draws keep both sides on one trajectory; tolerance 1e-5 as between the
reference's own backends."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.configs.base import ADMMConfig as RConfig
from repro.core import consensus as rcons
from repro.core import space as rspace
from repro_torch import api
from repro_torch.configs.base import ADMMConfig
from repro_torch.core import consensus, space
from repro_torch.data import make_sparse_logreg

N, DIM, M = 4, 512, 8
TOL = 1e-5
CFG = dict(rho=2.0, gamma=0.1, block_fraction=0.5, num_blocks=M,
           l1_coef=1e-3, clip=1.0, block_selection="gauss_southwell",
           seed=0)
DATA = make_sparse_logreg(N, 32, DIM, density=0.03, locality=0.95, seed=3)
RHO_SCALE = np.array([0.5, 1.0, 2.0, 1.5], np.float32)


def _jax_logreg(z, d):
    X, y = d
    return jnp.mean(jnp.log1p(jnp.exp(-y * (X @ z))))


def _torch_logreg(z, d):
    X, y = d
    return torch.mean(torch.log1p(torch.exp(-y * (X @ z))))


def _sessions(backend="jnp", delays=None):
    """(reference, port) sessions; ``delays`` (rounds, N, M) replays a
    recorded delay matrix, else every read is one epoch stale."""
    if delays is None:
        rdm, pdm = rspace.ConstantDelay(1), space.ConstantDelay(1)
    else:
        rdm, pdm = rspace.TraceDelay(delays), space.TraceDelay(delays)
    ref = rapi.ConsensusSession.flat(
        _jax_logreg, (jnp.asarray(DATA.X), jnp.asarray(DATA.y)), dim=DIM,
        cfg=RConfig(**CFG), support=DATA.support, rho_scale=RHO_SCALE,
        delay_model=rdm, backend=backend)
    port = api.ConsensusSession.flat(
        _torch_logreg, (DATA.X, DATA.y), dim=DIM, cfg=ADMMConfig(**CFG),
        support=DATA.support, rho_scale=RHO_SCALE, delay_model=pdm,
        device="cpu")
    return ref, port


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                               atol=TOL, **kw)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_session_run_and_measures_match_reference(backend):
    ref, port = _sessions(backend)
    rstate, rhist = ref.run(30, eval_every=10)
    pstate, phist = port.run(30, eval_every=10)
    assert [h["epoch"] for h in phist] == [h["epoch"] for h in rhist]
    for p, r in zip(phist, rhist):
        _close(p["objective"], r["objective"])
        _close(p["loss"], r["loss"])
    _close(port.z(pstate).numpy(), ref.z(rstate))
    assert phist[-1]["objective"] < port.objective(port.init())
    _close(port.consensus_residual(pstate), ref.consensus_residual(rstate))
    ps, rs = port.stationarity(pstate), ref.stationarity(rstate)
    assert set(ps) == set(rs)
    for k in rs:
        _close(float(ps[k]), float(rs[k]), err_msg=k)
    pk, rk = port.kkt_violations(pstate), ref.kkt_violations(rstate)
    assert set(pk) == set(rk)
    for k in rk:
        _close(float(pk[k]), float(rk[k]), err_msg=k)


def test_solve_matches_reference():
    kw = dict(support=DATA.support, l1_coef=1e-3, clip=1.0,
              delay_model=None)
    cfg = dict(CFG, max_delay=0, block_fraction=1.0, block_selection="cyclic")
    rz, rhist = rapi.solve(_jax_logreg,
                           (jnp.asarray(DATA.X), jnp.asarray(DATA.y)), DIM,
                           num_epochs=25, cfg=RConfig(**cfg), **kw)
    pz, phist = api.solve(_torch_logreg, (DATA.X, DATA.y), DIM,
                          num_epochs=25, cfg=ADMMConfig(**cfg),
                          device="cpu", **kw)
    _close(pz.numpy(), rz)
    assert len(phist) == len(rhist) == 1
    _close(phist[-1]["objective"], rhist[-1]["objective"])


def test_flat_driver_run_matches_reference():
    """``core.consensus.run`` (the driver under the session) with the
    config's own draw-free policies: synchronous, every block."""
    cfg = dict(CFG, max_delay=0, block_fraction=1.0)
    rprob = rcons.make_problem(_jax_logreg,
                               (jnp.asarray(DATA.X), jnp.asarray(DATA.y)),
                               DIM, M, support=DATA.support, l1_coef=1e-3,
                               clip=1.0)
    pprob = consensus.make_problem(_torch_logreg, (DATA.X, DATA.y), DIM, M,
                                   support=DATA.support, l1_coef=1e-3,
                                   clip=1.0, device="cpu")
    rstate, rhist = rcons.run(rprob, RConfig(**cfg), 12, eval_every=4)
    pstate, phist = consensus.run(pprob, ADMMConfig(**cfg), 12, eval_every=4)
    assert [h["epoch"] for h in phist] == [4, 8, 12]
    for p, r in zip(phist, rhist):
        _close(p["objective"], r["objective"])
    _close(pstate.z_blocks.numpy(), rstate.z_blocks)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_run_started_in_jax_continues_in_the_port(backend):
    """5 epochs in JAX, the state carried over as numpy, 5 more in both."""
    delays = np.random.RandomState(4).randint(0, 3, size=(10, N, M))
    ref, port = _sessions(backend, delays)
    step = ref.step_fn()
    rstate = ref.init()
    for _ in range(5):
        rstate, _ = step(rstate, ref.data)
    pstate = space.state_from_numpy(
        {k: np.asarray(v) for k, v in rstate._asdict().items()}, port.spec,
        device="cpu")
    assert pstate.t == 5
    for _ in range(5):
        rstate, _ = step(rstate, ref.data)
        pstate, _ = port.step(pstate)
        _close(port.z(pstate).numpy(), ref.z(rstate))
    _close(pstate.y.numpy(), rstate.y)
    _close(pstate.x.numpy(), rstate.x)
    with pytest.raises(ValueError, match="z_hist"):
        space.state_from_numpy(
            {"z_hist": np.zeros((1, M, 128)), "y": 0, "w_cache": 0, "x": 0,
             "t": 0}, port.spec, device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means CUDA; without a card that is an error, never
    a quiet move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.ConsensusSession.flat(_torch_logreg, (DATA.X, DATA.y), dim=DIM,
                                  cfg=ADMMConfig(**CFG))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.solve(_torch_logreg, (DATA.X, DATA.y), DIM, num_epochs=1)


def test_session_defaults_and_batches():
    _, port = _sessions()
    assert port.spec.space.backend == "torch"
    assert port.spec.device.type == "cpu"
    z0 = np.full(DIM, 0.01, np.float32)
    state = port.init(z0)
    np.testing.assert_array_equal(port.z(state).numpy(), z0)
    a, info_a = port.step(state)
    b, info_b = port.step(state, port.data)
    assert torch.equal(a.z_blocks, b.z_blocks)
    assert 0.0 < float(info_a["selected_fraction"]) <= 1.0
    seen = []
    port.run(3, batches=lambda t: seen.append(t) or port.data)
    assert seen == [0, 1, 2]
