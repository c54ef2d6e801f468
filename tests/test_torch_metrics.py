"""The port's ``core/metrics.py::stationarity_blocks`` and the names
``core/consensus.py`` gained beside it (``AsyBADMMState``,
``asybadmm_step``, ``ConsensusProblem.rho_vec`` / ``worker_loss``),
against the reference's on one problem (tests/test_metrics.py's: a
draw-free config, so both packages take the same epochs).

* ``stationarity_blocks`` is the reference's block by block (1e-5), and
  sums in squares to ``stationarity``'s totals under a per-worker rho
  vector (tests/test_metrics.py:181);
* ``asybadmm_step`` is one epoch, its state an ``AsyBADMMState``;
  ``rho_vec`` and ``worker_loss`` are the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as rcore
from repro.configs.base import ADMMConfig as RConfig
from repro_torch import core
from repro_torch.configs.base import ADMMConfig

N, M, DBLK = 3, 4, 5
DIM = M * DBLK
TOL = 1e-5

_r = np.random.RandomState(7)
CENTERS = _r.randn(N, DIM).astype(np.float32)
EDGE = np.array([[1, 1, 0, 1],
                 [1, 0, 1, 0],
                 [1, 1, 1, 1]], bool)
RHO_SCALE = np.array([0.5, 1.0, 2.0], np.float32)
CFG = dict(rho=2.0, gamma=0.1, max_delay=0, block_fraction=1.0,
           num_blocks=M, block_selection="cyclic", l1_coef=1e-3, clip=0.8,
           seed=0)


def _problems(rho_scale=RHO_SCALE):
    kw = dict(dim=DIM, num_blocks=M, edge=EDGE, l1_coef=1e-3, clip=0.8,
              rho_scale=rho_scale)
    return (rcore.make_problem(lambda z, c: 0.5 * jnp.sum(jnp.square(z - c)),
                               jnp.asarray(CENTERS), **kw),
            core.make_problem(lambda z, c: 0.5 * torch.sum(
                torch.square(z - c)), CENTERS, device="cpu", **kw))


def _evolved(steps=5):
    """Both packages' states after ``steps`` epochs of asybadmm_step."""
    rprob, tprob = _problems()
    rcfg, tcfg = RConfig(**CFG), ADMMConfig(**CFG)
    rs, ts = rcore.init_state(rprob, rcfg), core.init_state(tprob, tcfg)
    for _ in range(steps):
        rs = rcore.asybadmm_step(rprob, rcfg, rs)
        ts = core.asybadmm_step(tprob, tcfg, ts)
    return (rprob, rcfg, rs), (tprob, tcfg, ts)


def test_asybadmm_step_is_one_epoch():
    (rprob, _, rs), (tprob, tcfg, ts) = _evolved()
    assert core.AsyBADMMState is core.ConsensusState
    assert isinstance(ts, core.AsyBADMMState) and ts.t == 5
    np.testing.assert_allclose(ts.z_blocks.numpy(), np.asarray(rs.z_hist[0]),
                               rtol=TOL, atol=TOL)
    spec = tprob.spec(tcfg)
    state = core.init_state(tprob, tcfg)
    for _ in range(5):
        state, _ = core.asybadmm_epoch(spec, state, tprob.data)
    assert torch.equal(state.z_blocks, ts.z_blocks)


@pytest.mark.parametrize("rho_scale", [None, RHO_SCALE])
def test_rho_vec_and_worker_loss_match_reference(rho_scale):
    rprob, tprob = _problems(rho_scale)
    np.testing.assert_allclose(tprob.rho_vec(2.0).numpy(),
                               np.asarray(rprob.rho_vec(2.0)), rtol=0, atol=0)
    assert tprob.rho_vec(2.0).dtype == torch.float32
    z = np.random.RandomState(1).randn(DIM).astype(np.float32)
    for i in range(N):
        np.testing.assert_allclose(
            float(tprob.worker_loss(torch.as_tensor(z), i)),
            float(rprob.worker_loss(jnp.asarray(z), i)), rtol=TOL)


def test_stationarity_blocks_matches_reference_and_sums_to_totals():
    (rprob, rcfg, rs), (tprob, tcfg, ts) = _evolved()
    rho_vec = tcfg.rho * torch.as_tensor(RHO_SCALE)
    got = core.stationarity_blocks(tprob, ts, rho_vec)
    want = rcore.stationarity_blocks(rprob, rs,
                                     rcfg.rho * jnp.asarray(RHO_SCALE))
    assert set(got) == {"primal", "prox", "grad", "P"}
    for k, v in got.items():
        assert v.shape == (M,)
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    total = core.stationarity(tprob, ts, rho_vec)
    for part, key in (("primal", "primal_residual"), ("grad", "grad_norm"),
                      ("prox", "prox_residual")):
        np.testing.assert_allclose(
            float(torch.sqrt(torch.sum(torch.square(got[part])))),
            float(total[key]), rtol=1e-5)
    np.testing.assert_allclose(float(torch.sum(got["P"])), float(total["P"]),
                               rtol=1e-5)
