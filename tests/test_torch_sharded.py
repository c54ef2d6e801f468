"""The port's SPMD epoch (``repro_torch/core/sharded.py``) on a gloo
process group of 8 CPU ranks, data=4 x model=2 (the reference's own test
mesh, tests/test_spmd_parity.py:42-44).

One module-scoped fixture spawns the 8 ranks once; every scenario runs
in that one group (``torch_sharded_ranks.run_rank``) and comes back
through a file per rank. The tests then hold the sharded z trajectory,
at every epoch and on every rank, within 1e-5 of

* the JAX reference's single-device epoch, with its draws injected on
  both sides (``TraceDelay`` replaying the delays its own delay model
  draws, and a callable selector replaying its own selector's picks;
  Gauss-Southwell draws nothing and runs by name), and
* the port's own single-device epoch with the port's own draws —

for ``random``, ``cyclic`` and ``gauss_southwell`` selection, the
8-worker split-gradient case and Pareto delays up to 3, at the shapes of
tests/test_spmd_parity.py. They also check the local tile shapes and data
rows, the mesh's divisibility errors, group layout and preset cache, a sharded run continued
from the reference's state (``state_from_numpy``), and the session's
measures on the sharded state against the single-device ones.
"""
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_sharded_ranks as ranks
from repro import api as rapi
from repro.configs.base import ADMMConfig as RConfig
from repro.core import space as rspace

WORLD = 8                                   # data=4 x model=2
JOIN_TIMEOUT_S = 240
N, M, DBLK = 4, 8, 5
DIM = M * DBLK
LANE = 128
EPOCHS = 6
RESUME_AT = 3                               # state_from_numpy's epoch
TOL = 1e-5

_r = np.random.RandomState(7)
CENTERS = _r.randn(N, DIM).astype(np.float32)
EDGE = _r.rand(N, M) < 0.8
EDGE[:, 0] = True                           # every worker touches block 0
RHO_SCALE = np.array([0.5, 1.0, 2.0, 1.5], np.float32)
_r8 = np.random.RandomState(11)
CENTERS8 = _r8.randn(8, DIM).astype(np.float32)
EDGE8 = _r8.rand(8, M) < 0.8
EDGE8[:, 0] = True
RHO8 = np.linspace(0.5, 2.0, 8).astype(np.float32)

MEASURED = ("random", "split_grads")        # cases whose measures are held
# name: (selector, delay model (kind, D[, alpha]), workers' data)
CASES = {
    "random": ("random", ("uniform", 1), "four"),
    "cyclic": ("cyclic", ("uniform", 1), "four"),
    "gauss_southwell": ("gauss_southwell", ("uniform", 1), "four"),
    "split_grads": ("random", ("uniform", 1), "eight"),
    "pareto": ("random", ("pareto", 3, 1.2), "pareto"),
}


def _problem(which):
    """(centers, edge, rho_scale, max_delay) of a case."""
    if which == "eight":
        return CENTERS8, EDGE8, RHO8, 1
    if which == "pareto":
        return CENTERS, EDGE, None, 3
    return CENTERS, EDGE, RHO_SCALE, 1


def _cfg(scheme, max_delay):
    return dict(rho=2.0, gamma=0.1, max_delay=max_delay, block_fraction=0.5,
                num_blocks=M, block_selection=scheme, l1_coef=1e-3,
                clip=0.8, seed=0)


def _reference_draws(scheme, dm, edge):
    """The delays and selections the reference's own single-device epoch
    draws with these policies: its per-epoch key split, its delay model,
    its selector (Gauss-Southwell draws nothing: None)."""
    kind, *args = dm
    rdm = {"uniform": rspace.UniformDelay, "pareto": rspace.ParetoDelay}[
        kind](*args)
    rng = jax.random.PRNGKey(0)
    delays, sels = [], []
    for t in range(EPOCHS):
        rng, r_delay, r_sel, _ = rspace.epoch_keys(rng, None)
        delays.append(np.asarray(rspace.sample_delay_model(
            rdm, r_delay, edge.shape[0], M, t)))
        if scheme != "gauss_southwell":
            ctx = rspace.SelectorContext(
                rng=r_sel, edge=jnp.asarray(edge), t=jnp.int32(t),
                block_fraction=0.5, grad_sqnorm=None)
            sels.append(np.asarray(rspace.BLOCK_SELECTORS[scheme](ctx)))
    return np.stack(delays), (np.stack(sels) if sels else None)


def _scenarios():
    """Every scenario the ranks run: each case with the reference's draws
    injected ("<case>/injected") and with the port's own ("<case>/own")."""
    out = {}
    for name, (scheme, dm, which) in CASES.items():
        centers, edge, rho_scale, max_delay = _problem(which)
        base = dict(centers=centers, edge=edge, rho_scale=rho_scale, dim=DIM,
                    cfg=_cfg(scheme, max_delay), epochs=EPOCHS,
                    measures=name in MEASURED)
        delays, sels = _reference_draws(scheme, dm, edge)
        out[f"{name}/injected"] = dict(base, delays=delays, sels=sels)
        out[f"{name}/own"] = dict(base, delay_model=dm)
    # the reference's state after RESUME_AT epochs, for state_from_numpy
    key = "split_grads/injected"
    out[key]["resume"] = _reference_run(out[key], epochs=RESUME_AT)["state"]
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(scenarios, per-rank results) of one 8-rank gloo run."""
    tmp = tmp_path_factory.mktemp("sharded")
    scenarios = _scenarios()
    ctx = mp.start_processes(
        ranks.run_rank, args=(WORLD, f"file://{tmp}/store", scenarios,
                              str(tmp)),
        nprocs=WORLD, start_method="spawn", join=False)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                pytest.fail(f"the {WORLD} ranks did not finish within "
                            f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r in range(WORLD):
        results.append(pickle.loads((tmp / f"rank{r}.pkl").read_bytes()))
    return scenarios, results


def _jax_quad(z, c):
    return 0.5 * jnp.sum(jnp.square(z - c))


def _reference_run(sc, epochs=EPOCHS):
    """The JAX reference's single-device run of an injected scenario."""
    sels = None if sc["sels"] is None else jnp.asarray(sc["sels"])
    sel = sc["cfg"]["block_selection"] if sels is None else (
        lambda ctx: sels[ctx.t] & ctx.edge)
    sess = rapi.ConsensusSession.flat(
        _jax_quad, jnp.asarray(sc["centers"]), dim=DIM,
        cfg=RConfig(**sc["cfg"]), edge=sc["edge"],
        rho_scale=sc["rho_scale"], delay_model=rspace.TraceDelay(
            sc["delays"]), selector=sel)
    step = sess.step_fn()
    state = sess.init()
    zs, losses, fracs = [], [], []
    for _ in range(epochs):
        state, info = step(state, sess.data)
        zs.append(np.asarray(sess.z(state)))
        losses.append(float(info["loss"]))
        fracs.append(float(info["selected_fraction"]))
    measures = {"objective": sess.objective(state),
                "consensus_residual": sess.consensus_residual(state)}
    for k, v in {**sess.stationarity(state),
                 **sess.kkt_violations(state)}.items():
        measures[k] = float(v)
    return {"z": np.stack(zs), "loss": np.array(losses),
            "selected_fraction": np.array(fracs), "measures": measures,
            "state": {k: np.asarray(v) for k, v in state._asdict().items()}}


def _assert_trajectory(got, want):
    for t in range(EPOCHS):
        np.testing.assert_allclose(
            got["z"][t], want["z"][t], rtol=TOL, atol=TOL,
            err_msg=f"sharded z diverged from single device at epoch {t}")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got["selected_fraction"],
                                  want["selected_fraction"])
    assert np.abs(want["z"][-1]).max() > 0.0           # the run moved


def _every_rank(results, key):
    """``key``'s result from rank 0, after checking every rank saw the
    same z trajectory."""
    for r in results[1:]:
        np.testing.assert_array_equal(r[key]["z"], results[0][key]["z"])
    return results[0][key]


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_jax_reference(sharded, case):
    scenarios, results = sharded
    key = f"{case}/injected"
    _assert_trajectory(_every_rank(results, key),
                       _reference_run(scenarios[key]))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_matches_port_single_device(sharded, case):
    scenarios, results = sharded
    key = f"{case}/own"
    _assert_trajectory(_every_rank(results, key),
                       ranks.run_scenario(scenarios[key]))


def test_sharded_run_continues_a_reference_state(sharded):
    """``state_from_numpy`` takes the reference's full single-device state
    after 3 epochs and keeps each rank's tiles; 3 more sharded epochs
    (split gradients) follow the reference's epochs 4-6."""
    scenarios, results = sharded
    key = "split_grads/injected"
    want = _reference_run(scenarios[key])["z"][RESUME_AT:]
    for r in results:
        got = r[key]["resumed_z"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case,local_workers,split", [
    ("random", 1, None), ("split_grads", 2, 1)])
def test_local_tiles_are_sharded(sharded, case, local_workers, split):
    """Workers over data, blocks over model: every rank holds
    (N/4, M/2, 128) worker tiles (block_dim is lane-rounded, 5 -> 128)
    and a (depth, M/2, 128) ring, and keeps only the data rows it
    differentiates (the reference's ``consensus_data_specs``): its local
    workers', or under the split gradient pass its share of them."""
    scenarios, results = sharded
    centers = scenarios[f"{case}/own"]["centers"]
    for rank, r in enumerate(results):
        res = r[f"{case}/own"]
        assert res["grad_split_size"] == split
        for k in ("y", "w_cache", "x"):
            assert res["shapes"][k] == (local_workers, M // 2, LANE)
        assert res["shapes"]["z_hist"] == (2, M // 2, LANE)
        rows = split or local_workers
        first = r["coords"]["data"] * local_workers + (
            r["coords"]["model"] * split if split else 0)
        np.testing.assert_array_equal(res["data"],
                                      centers[first:first + rows])


def test_mesh_layout_and_presets(sharded):
    """The (data=4, model=2) test mesh lays the 8 ranks out row-major; a
    preset name resolves to one mesh per process group, however many
    specs are built from it."""
    _, results = sharded
    coords = sorted((r["coords"]["data"], r["coords"]["model"])
                    for r in results)
    assert coords == [(d, m) for d in range(4) for m in range(2)]
    for r in results:
        assert r["preset"] == {"same_mesh": True, "shape": {"data": 4,
                                                            "model": 2}}


def test_mesh_divisibility_errors(sharded):
    """Bad (mesh, problem) pairings fail eagerly, on every rank, with the
    reference's wording keys; a mesh larger than the group is refused."""
    _, results = sharded
    for r in results:
        errs = r["errors"]
        assert errs["num_workers"][0] == "ValueError"
        assert "num_workers" in errs["num_workers"][1]
        assert errs["num_blocks"][0] == "ValueError"
        assert "num_blocks" in errs["num_blocks"][1]
        assert errs["world_short"][0] == "RuntimeError"
        assert "16 ranks" in errs["world_short"][1]


@pytest.mark.parametrize("case", MEASURED)
@pytest.mark.parametrize("against", ["jax_reference", "port_single_device"])
def test_measures_on_the_sharded_state(sharded, against, case):
    """objective, residual, stationarity P and the KKT violations of the
    sharded state are the single-device numbers, on every rank, with and
    without the split gradient pass (partial results completed over the
    groups; no worker bundle is gathered)."""
    scenarios, results = sharded
    if against == "jax_reference":
        key = f"{case}/injected"
        want = _reference_run(scenarios[key])["measures"]
    else:
        key = f"{case}/own"
        want = ranks.run_scenario(scenarios[key])["measures"]
    for r in results:
        got = r[key]["measures"]
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL,
                                       err_msg=k)


def test_pod_mesh_flattens_pod_and_data_into_the_data_group(sharded):
    """(pod=2, data=2, model=2): ranks laid out row-major; the data group
    holds the ranks of one model index, in (pod, data) order, and a
    rank's place in it is its worker-shard index."""
    _, results = sharded
    for rank, r in enumerate(results):
        pm = r["pod_mesh"]
        p, d, m = rank // 4, (rank // 2) % 2, rank % 2
        assert pm["coords"] == {"pod": p, "data": d, "model": m}
        assert pm["worker_shard_index"] == 2 * p + d
        assert pm["data_group"] == [m, 2 + m, 4 + m, 6 + m]
        assert pm["model_group"] == [rank - m, rank - m + 1]
        assert pm["data_group"].index(rank) == pm["worker_shard_index"]
