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

Pytree sessions run on the same ranks (``TREE_CASES``, one leaf per
block as in tests/test_spmd_parity.py:98): the model axis splits the
packed table's rows, never its lanes, and the sharded tree trajectory is
held against the reference's single-device ``ConsensusSession.pytree``
(injected draws) and the port's own single-device tree epoch.

``ADMMTrainer.train_step`` runs on ranks 0-3 of the same spawn under a
(data=2, model=2) mesh that splits the block table (the qwen3-1.7b
smoke, N = M = 4, no draws): each rank's tile after every step within
1e-5 of the reference's single-device ``ADMMTrainer`` (the reference's
own SPMD step equals it, tests/test_spmd_parity.py) and of the port's;
the newest z gathered into the full tree; the cost counter's count of
one epoch on rank r equal to ``per_shard_cost_program``'s on an
abstract mesh (collectives charged alike by kind). On the same ranks,
``train_step_block``'s Gauss-Seidel rounds on the mesh against the
reference's and the port's single-device rounds, each rank's tiles
against ``local_shard`` of the single-device tables, and the bytes a
rank holds against the dry run's reckoning. Every rank also trains
through ``launch/train.py --mesh test``.
"""
import functools
import pickle
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp

import torch_sharded_ranks as ranks
from repro import api as rapi
from repro.configs import get_smoke as ref_smoke
from repro.configs.base import ADMMConfig as RConfig
from repro.core import space as rspace
from repro.core.blocks import TreeBlocks
from repro.models import build_model as ref_build
from repro.training import ADMMTrainer as RTrainer
from repro_torch.checkpoint import load_arrays, load_step
from repro_torch.configs import get_smoke
from repro_torch.launch import train as launch_train

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


# pytree sessions: name -> (selector, delay model, workers' data)
TREE_CASES = {
    "tree_random": ("random", ("uniform", 1), "four"),
    "tree_split_grads": ("random", ("uniform", 1), "eight"),
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
    for name, (scheme, dm, which) in TREE_CASES.items():
        centers, edge, rho_scale, max_delay = _problem(which)
        base = dict(centers=centers, edge=edge, rho_scale=rho_scale, dim=DIM,
                    cfg=_cfg(scheme, max_delay), epochs=EPOCHS, tree=True)
        delays, sels = _reference_draws(scheme, dm, edge)
        out[f"{name}/injected"] = dict(base, delays=delays, sels=sels)
        out[f"{name}/own"] = dict(base, delay_model=dm)
    out["trainer"] = _trainer_scenario()
    # the reference's state after RESUME_AT epochs, for state_from_numpy
    key = "split_grads/injected"
    out[key]["resume"] = _reference_run(out[key], epochs=RESUME_AT)["state"]
    return out


TRAINER_ARCH, TRAINER_N, TRAINER_M, TRAINER_STEPS = "qwen3-1.7b", 4, 4, 3
TRAINER_ADMM = dict(rho=5.0, gamma=0.01, num_blocks=TRAINER_M,
                    block_fraction=1.0, max_delay=0, seed=0)


def _trainer_batches():
    r = np.random.RandomState(2)
    out = []
    for _ in range(TRAINER_STEPS):
        tok = r.randint(0, 512, (TRAINER_N, 2, 17))
        out.append({"tokens": tok[..., :-1], "labels": tok[..., 1:]})
    return out


def _trainer_scenario():
    """The trainer case the ranks run: the reference's smoke weights as
    numpy, the batches, the config (no draws: every block selected, no
    delay)."""
    rparams = _reference_smoke()[1]
    return dict(trainer=True, cfg=get_smoke(TRAINER_ARCH),
                params=jax.tree.map(np.asarray, rparams),
                batches=_trainer_batches(), workers=TRAINER_N,
                admm=TRAINER_ADMM)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(scenarios, per-rank results) of one 8-rank gloo run."""
    tmp = tmp_path_factory.mktemp("sharded")
    scenarios = _scenarios()
    (tmp / "scenarios.pkl").write_bytes(pickle.dumps(scenarios))
    ctx = mp.start_processes(
        ranks.run_rank, args=(WORLD, f"file://{tmp}/store",
                              str(tmp / "scenarios.pkl"), str(tmp)),
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


def _reference_tree_run(sc, sel):
    """The JAX reference's single-device pytree run of an injected tree
    scenario: z after each epoch, leaves concatenated in block order."""
    M_ = sc["cfg"]["num_blocks"]
    params = {f"w{j}": jnp.zeros(DIM // M_, jnp.float32) for j in range(M_)}
    blocks = TreeBlocks(num_blocks=M_, leaf_block_ids=tuple(range(M_)),
                        treedef=jax.tree.structure(params))
    sess = rapi.ConsensusSession.pytree(
        lambda p, c: _jax_quad(jnp.concatenate(
            [p[f"w{j}"] for j in range(M_)]), c),
        params, RConfig(**sc["cfg"]), num_workers=sc["centers"].shape[0],
        blocks=blocks, edge=sc["edge"], rho_scale=sc["rho_scale"],
        delay_model=rspace.TraceDelay(sc["delays"]), selector=sel)
    step = sess.step_fn()
    state = sess.init()
    batch = jnp.asarray(sc["centers"])
    zs, losses, fracs = [], [], []
    for _ in range(sc["epochs"]):
        state, info = step(state, batch)
        z = sess.z(state)
        zs.append(np.concatenate([np.asarray(z[f"w{j}"])
                                  for j in range(M_)]))
        losses.append(float(info["loss"]))
        fracs.append(float(info["selected_fraction"]))
    return {"z": np.stack(zs), "loss": np.array(losses),
            "selected_fraction": np.array(fracs)}


def _reference_run(sc, epochs=EPOCHS):
    """The JAX reference's single-device run of an injected scenario."""
    sels = None if sc["sels"] is None else jnp.asarray(sc["sels"])
    sel = sc["cfg"]["block_selection"] if sels is None else (
        lambda ctx: sels[ctx.t] & ctx.edge)
    if sc.get("tree"):
        return _reference_tree_run(sc, sel)
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


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_tree_sharded_matches_jax_reference(sharded, case):
    scenarios, results = sharded
    key = f"{case}/injected"
    _assert_trajectory(_every_rank(results, key),
                       _reference_run(scenarios[key]))


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_tree_sharded_matches_port_single_device(sharded, case):
    """Also: each rank holds (N/4, M/2, 128) worker tiles of the packed
    table, full lane-aligned rows (tests/test_block_layout.py's sharded
    divisibility case)."""
    scenarios, results = sharded
    key = f"{case}/own"
    _assert_trajectory(_every_rank(results, key),
                       ranks.run_scenario(scenarios[key]))
    local = scenarios[key]["centers"].shape[0] // 4
    for r in results:
        assert r[key]["shapes"]["y"] == (local, M // 2, LANE)
        assert r[key]["shapes"]["z_hist"] == (2, M // 2, LANE)
        assert "x" not in r[key]["shapes"]


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


@functools.lru_cache(maxsize=None)
def _reference_smoke():
    """The reference's trainer-scenario model and its weights (seed 0),
    built once for the tests that run the reference's trainer."""
    rmodel = ref_build(ref_smoke(TRAINER_ARCH))
    return rmodel, rmodel.init(jax.random.PRNGKey(0))


def _reference_trainer_states():
    """The reference's single-device ``ADMMTrainer`` states after each
    step (params-shaped numpy leaves), on the trainer scenario."""
    rmodel, rparams = _reference_smoke()
    rt = RTrainer(loss_fn=rmodel.loss, admm=RConfig(**TRAINER_ADMM),
                  num_workers=TRAINER_N)
    state = rt.init(rparams)
    step = jax.jit(rt.train_step)
    out = []
    for b in _trainer_batches():
        state, info = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append({name: [np.asarray(t) for t in jax.tree.leaves(
            getattr(state, name))] for name in ("z_hist", "y", "w_cache")}
                   | {"loss": float(info["loss"])})
    return out


def test_trainer_on_a_mesh_that_splits_the_table(sharded):
    """Each rank's tile of ``ADMMTrainer.train_step`` under (data=2,
    model=2) against the reference's single-device trainer and the
    port's, step by step; the tiles cover the (N, M) grid; the gathered
    z is the reference's."""
    _, results = sharded
    ref = _reference_trainer_states()
    tiles = set()
    for r in range(4):
        got = results[r]["trainer"]
        n0, Nl, m0, Ml = got["tile"]
        assert (Nl, Ml) == (TRAINER_N // 2, TRAINER_M // 2)
        tiles.add((n0, m0))
        assert max(got["diffs_vs_single"]) <= TOL
        for step, want in zip(got["steps"], ref):
            np.testing.assert_allclose(step["loss"], want["loss"], rtol=TOL)
            for name in ("z_hist", "y", "w_cache"):
                assert step[name], f"rank {r} holds no {name} leaf"
                for k, t in step[name].items():
                    w = want[name][k]
                    if name != "z_hist":
                        w = w[n0:n0 + Nl]
                    assert t.shape == w.shape
                    assert float(np.abs(t - w).max()) <= \
                        TOL * (1.0 + float(np.abs(w).max()))
        for a, b in zip(got["gathered_params"], ref[-1]["z_hist"]):
            np.testing.assert_allclose(a, b[0], rtol=0, atol=TOL)
    assert tiles == {(0, 0), (0, 2), (2, 0), (2, 2)}
    for r in range(4, WORLD):
        assert results[r]["trainer"] is None


def _reference_block_rounds():
    """The reference's single-device ``train_step_block`` rounds (block
    ``i % M``) from ``init(cyclic=True)`` on the trainer scenario."""
    rmodel, rparams = _reference_smoke()
    rt = RTrainer(loss_fn=rmodel.loss, admm=RConfig(**TRAINER_ADMM),
                  num_workers=TRAINER_N)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in _trainer_batches()]

    @jax.jit
    def rounds(state, batches):             # one compile for the M rounds
        out = []
        for i in range(TRAINER_M):
            state, info = rt.train_step_block(
                state, batches[i % len(batches)], i)
            out.append((state.z_hist, state.y, info))
        return out

    return [{"z_hist": [np.asarray(t) for t in jax.tree.leaves(zh)],
             "y": [np.asarray(t) for t in jax.tree.leaves(y)],
             "loss": float(info["loss"]),
             "share": float(info["selected_fraction"])}
            for zh, y, info in rounds(rt.init(rparams, cyclic=True),
                                      batches)]


def test_block_round_on_a_mesh_that_splits_the_table(sharded):
    """``train_step_block`` under (data=2, model=2), M rounds from
    ``init(cyclic=True)``: each rank's tile within 1e-5 of the port's
    single-device round and of the reference's, round by round; the w
    cache stays dropped."""
    _, results = sharded
    ref = _reference_block_rounds()
    for r in range(4):
        got = results[r]["trainer"]
        n0, Nl, _, _ = got["tile"]
        rounds = got["block_round"]
        assert rounds["w_cache"] == ()
        assert max(rounds["diffs_vs_single"]) <= TOL
        for step, want in zip(rounds["steps"], ref):
            np.testing.assert_allclose(step["loss"], want["loss"], rtol=TOL)
            assert step["share"] == pytest.approx(want["share"], rel=1e-6)
            for name in ("z_hist", "y"):
                assert step[name], f"rank {r} holds no {name} leaf"
                for k, t in step[name].items():
                    w = want[name][k]
                    if name == "y":
                        w = w[n0:n0 + Nl]
                    assert t.shape == w.shape
                    assert float(np.abs(t - w).max()) <= \
                        TOL * (1.0 + float(np.abs(w).max()))
        assert len(rounds["steps"]) == TRAINER_M


def test_block_round_draws_delays_and_minibatch_on_a_mesh(sharded):
    """``train_step_block`` under (data=2, model=2) with bounded delay 1
    and a minibatch of half the sequences (delays and rows drawn at full
    (N, ...) and sliced to the tile), on the split gradient pass (N = 4)
    and with the owner alone differentiating (N = 2): each rank's tile
    within 1e-5 of the port's single-device round, round by round; the
    draws move z off the undrawn rounds'."""
    _, results = sharded
    for r in range(4):
        got = results[r]["trainer"]
        drawn = got["block_round_drawn"]
        assert drawn["split"]["tile"].split_grads
        assert not drawn["owner_only"]["tile"].split_grads
        for name, run in drawn.items():
            assert len(run["diffs_vs_single"]) == TRAINER_M
            assert max(run["diffs_vs_single"]) <= TOL, (r, name)
        undrawn = got["block_round"]["steps"][-1]["z_hist"]
        moved = max(float(np.abs(t - undrawn[k]).max())
                    for k, t in drawn["split"]["last"]["z_hist"].items())
        assert moved > 1e-4, r


def test_rank_state_is_its_shard_and_the_dryrun_bytes(sharded):
    """Each rank's tiles equal ``local_shard`` of the single-device
    tables under the base placement specs (within 1e-5: the two
    trajectories sum workers in another order), and the bytes it holds
    (the storages behind its state, the data rows it differentiates)
    equal ``launch/dryrun.py``'s reckoning for its rank of the mesh at
    this config and dtype (f32, no remat)."""
    _, results = sharded
    for r in range(4):
        got = results[r]["trainer"]
        assert got["local_shard_diff"] <= TOL
        assert got["held_bytes"] == got["dryrun_state_bytes"] > 0


def test_per_shard_cost_program_matches_the_counted_rank(sharded):
    """One epoch counted on each rank of the mesh (its collectives
    charged where they run) equals ``per_shard_cost_program``'s count of
    that rank's shard (rank 0's tile: every tile of this mesh has the
    same shapes) with ``SimCollectives`` and no process group."""
    _, results = sharded
    for r in range(4):
        got = results[r]["trainer"]
        assert got["same_cost"], (got["cost"], got["sim_cost"])
        cost = got["cost"]
        assert set(cost["collective_bytes"]) == {"all-reduce", "all-gather",
                                                 "all-to-all"}
        assert "admm_worker_select_update" not in cost["ops"]  # torch backend
        assert cost["flops"] > 0 and cost["hbm_bytes"] > 0


def test_launch_train_runs_under_the_test_mesh(sharded, tmp_path):
    """``launch/train.py --mesh test`` trains on all 8 ranks: 2 finite
    losses, the same on every rank and as the single-device run's; its
    ``--ckpt`` is one checkpoint, written by rank 0 alone, holding the
    single-device run's z."""
    _, results = sharded
    losses = [results[r]["launch_train"] for r in range(WORLD)]
    assert len(losses[0]) == 2 and all(np.isfinite(losses[0]))
    assert all(loss == losses[0] for loss in losses)
    ckpt = results[0]["launch_ckpt"]
    assert all(results[r]["launch_ckpt"] == ckpt for r in range(WORLD))
    single = str(tmp_path / "single")
    single_losses = launch_train.main(ranks.LAUNCH_ARGS + ["--ckpt", single])
    np.testing.assert_allclose(losses[0], single_losses, rtol=TOL)
    got, want = load_arrays(ckpt), load_arrays(single)
    assert load_step(ckpt) == load_step(single) == 2
    assert sorted(got) == sorted(want) and want
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL)
    assert not list(Path(ckpt).parent.glob("*.tmp"))
