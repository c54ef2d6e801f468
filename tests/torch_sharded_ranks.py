"""Rank side of ``tests/test_torch_sharded.py``.

``run_rank`` is one process of a gloo process group on the CPU: it
builds the (data=4, model=2) test mesh, runs every scenario it is given
through ``ConsensusSession.flat(..., mesh=mesh)`` (a scenario marked
``tree`` through ``ConsensusSession.pytree``: one leaf per block, its
centers the batch), checks the mesh
errors and the groups of a (pod, data, model) mesh, and pickles what it
saw to ``out_dir/rank<r>.pkl``. A scenario marked ``trainer`` runs
``ADMMTrainer.train_step`` on ranks 0-3 under a (data=2, model=2) mesh
that splits the block table (``trainer_scenario``: each rank's tile
after every step, the single-device step's diff, the tile against
``local_shard`` of the single-device tables, the bytes the rank holds
beside the dry run's reckoning, ``train_step_block``'s rounds, and on
every rank the cost counter's count of one epoch beside
``per_shard_cost_program``'s);
every rank then trains through ``launch/train.py --mesh test``. It imports
torch and the port only, so the spawned ranks never load JAX; scenarios
arrive as numpy arrays and plain values.
"""
import datetime
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.cost import count
from repro_torch.api import ConsensusSession
from repro_torch.configs.base import ADMMConfig
from repro_torch.core import space
from repro_torch.core.blocks import TreeBlocks
from repro_torch.core.sharded import (consensus_state_specs,
                                      grad_split_size, local_tile,
                                      per_shard_cost_program, rank_data)
from repro_torch.core.space import asybadmm_epoch
from repro_torch.core.tree import tree_leaves, tree_structure
from repro_torch.launch import dryrun
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import (local_shard, make_abstract_mesh,
                                     make_mesh, make_test_mesh,
                                     resolve_mesh)
from repro_torch.models import build_model, stacked_from_numpy
from repro_torch.training import ADMMTrainer

PG_TIMEOUT_S = 60
#: ``launch/train.py``'s arguments on every rank, beside ``--mesh test``
#: and a checkpoint path shared by the ranks
LAUNCH_ARGS = ["--device", "cpu", "--steps", "2", "--log-every", "1",
               "--seq", "16", "--batch", "4"]


def quad_loss(z, c):
    return 0.5 * torch.sum(torch.square(z - c))


def delay_model(sc):
    """The scenario's delay model: a recorded trace, else the port's own
    draws (``("uniform", D)`` or ``("pareto", D, alpha)``)."""
    if sc.get("delays") is not None:
        return space.TraceDelay(sc["delays"])
    kind, *args = sc["delay_model"]
    return {"uniform": space.UniformDelay, "pareto": space.ParetoDelay}[kind](
        *args)


def selector(sc):
    """A callable replaying recorded selections, else the config's own."""
    if sc.get("sels") is None:
        return None
    sels = torch.as_tensor(sc["sels"])
    return lambda ctx: sels[ctx.t] & ctx.edge


def tree_params(sc):
    """Leaves w0..w{M-1}, one per block, and the blocks pinning leaf j
    to block j."""
    M = sc["cfg"]["num_blocks"]
    params = {f"w{j}": torch.zeros(sc["dim"] // M) for j in range(M)}
    return params, TreeBlocks(num_blocks=M, leaf_block_ids=tuple(range(M)),
                              treedef=tree_structure(params))


def tree_loss(p, c):
    return quad_loss(torch.cat([p[f"w{j}"] for j in range(len(p))]), c)


def tree_vec(z):
    return torch.cat([z[f"w{j}"] for j in range(len(z))]).numpy().copy()


def session(sc, mesh=None):
    if sc.get("tree"):
        params, blocks = tree_params(sc)
        return ConsensusSession.pytree(
            tree_loss, params, ADMMConfig(**sc["cfg"]),
            num_workers=sc["centers"].shape[0], blocks=blocks,
            edge=sc["edge"], rho_scale=sc.get("rho_scale"),
            delay_model=delay_model(sc), selector=selector(sc), mesh=mesh,
            device="cpu")
    return ConsensusSession.flat(
        quad_loss, sc["centers"], dim=sc["dim"], cfg=ADMMConfig(**sc["cfg"]),
        edge=sc["edge"], rho_scale=sc.get("rho_scale"),
        delay_model=delay_model(sc), selector=selector(sc), mesh=mesh,
        device="cpu")


def measures(sess, state):
    """Every inspection method of the session, as floats."""
    out = {"objective": sess.objective(state),
           "consensus_residual": sess.consensus_residual(state)}
    for k, v in {**sess.stationarity(state),
                 **sess.kkt_violations(state)}.items():
        out[k] = float(v)
    return out


def run_scenario(sc, mesh=None):
    """Drive ``sc`` for its epochs; the z after each epoch, the infos,
    the local tile shapes and (when asked) the measures."""
    sess = session(sc, mesh)
    tree = bool(sc.get("tree"))
    batch = torch.as_tensor(sc["centers"]) if tree else None
    to_numpy = tree_vec if tree else (lambda z: z.numpy().copy())
    state = sess.init()
    zs, losses, fracs = [], [], []
    for _ in range(sc["epochs"]):
        state, info = sess.step(state, batch)
        zs.append(to_numpy(sess.z(state)))
        losses.append(float(info["loss"]))
        fracs.append(float(info["selected_fraction"]))
    out = {"z": np.stack(zs), "loss": np.array(losses),
           "selected_fraction": np.array(fracs),
           "shapes": {k: tuple(getattr(state, k).shape)
                      for k in ("z_hist", "y", "w_cache", "x")
                      if getattr(state, k) is not None}}
    if not tree:
        out["data"] = sess.data.numpy().copy()
    if mesh is not None:
        out["grad_split_size"] = grad_split_size(sess.spec)
    if sc.get("measures"):
        out["measures"] = measures(sess, state)
    if sc.get("resume") is not None:
        # continue a run from the full single-device state of epoch t
        state = space.state_from_numpy(sc["resume"], sess.spec, device="cpu")
        zs = []
        for _ in range(state.t, sc["epochs"]):
            state, _ = sess.step(state)
            zs.append(sess.z(state).numpy().copy())
        out["resumed_z"] = np.stack(zs)
    return out


def mesh_errors(mesh, sc):
    """The messages of the mesh's refusals, by case."""
    errors = {}
    cases = {
        "num_workers": lambda: session(dict(sc, centers=sc["centers"][:3],
                                            edge=None, rho_scale=None), mesh),
        "num_blocks": lambda: session(dict(sc, edge=None, cfg=dict(
            sc["cfg"], num_blocks=7)), mesh),
        "world_short": lambda: make_test_mesh(16, 2),
    }
    for name, fn in cases.items():
        try:
            fn()
            errors[name] = None
        except (ValueError, RuntimeError) as e:
            errors[name] = (type(e).__name__, str(e))
    return errors


TRAINER_MESH = ((2, 2), ("data", "model"))


def trainer_scenario(sc, rank):
    """``ADMMTrainer.train_step`` of the scenario's model on the (data=2,
    model=2) mesh over ranks 0-3 (every rank builds the mesh's groups;
    ranks 4-7 then stop): each step's tile leaves by leaf index, the
    tile, the largest difference from the single-device trainer's state
    after every step, and the costs of one more epoch counted on the
    mesh and by ``per_shard_cost_program`` on an abstract mesh."""
    try:
        mesh = make_mesh(*TRAINER_MESH)
    except RuntimeError:
        return None                      # a rank outside the mesh
    model = build_model(sc["cfg"])
    params = stacked_from_numpy(sc["cfg"], sc["params"], "cpu")
    batches = [{k: torch.as_tensor(v) for k, v in b.items()}
               for b in sc["batches"]]

    def trainer(m):
        return ADMMTrainer(loss_fn=model.loss, admm=ADMMConfig(**sc["admm"]),
                           num_workers=sc["workers"], mesh=m, device="cpu")

    tr, single = trainer(mesh), trainer(None)
    state, s_state = tr.init(params), single.init(params)
    spec = tr._spec(state.params)
    leaf_ids = spec.space.layout.window_leaf_ids(tr.window(spec))
    tile = local_tile(spec)
    steps, diffs = [], []
    for b in batches:
        state, info = tr.train_step(state, b)
        s_state, s_info = single.train_step(s_state, b)
        leaves = {name: dict(zip(leaf_ids, (
            t.numpy().copy() for t in tree_leaves(getattr(state, name)))))
            for name in ("z_hist", "y", "w_cache")}
        steps.append(dict(leaves, loss=float(info["loss"])))
        diff = 0.0
        for name in ("z_hist", "y", "w_cache"):
            full = tree_leaves(getattr(s_state, name))
            for k, t in leaves[name].items():
                want = full[k].numpy()
                if name != "z_hist":
                    want = want[tile.n0:tile.n0 + tile.Nl]
                diff = max(diff, float(np.abs(t - want).max()))
        diffs.append(diff)
    # the tile is the rank's shard of the single-device tables under the
    # base placement specs (local_shard by this rank's mesh coordinates)
    packed, full = tr._packed(spec, state), single._packed(
        single._spec(params), s_state)
    full_specs = consensus_state_specs(spec, full)
    shard_diff = max(float((local_shard(getattr(full, k), getattr(
        full_specs, k), mesh) - getattr(packed, k)).abs().max())
        for k in ("z_hist", "y", "w_cache"))
    # one more epoch counted on the mesh, and one shard of it costed
    # with no process group
    _, real = count(asybadmm_epoch, spec, packed, batches[0])
    abstract = trainer(make_abstract_mesh(*TRAINER_MESH))
    fn, args = per_shard_cost_program(abstract._spec(params), batches[0],
                                      z0=params)
    _, sim = count(fn, *args)
    return {"tile": (tile.n0, tile.Nl, tile.m0, tile.Ml), "steps": steps,
            "diffs_vs_single": diffs, "cost": real.row(),
            "sim_cost": sim.row(), "same_cost": real.same(sim),
            "gathered_params": [t.numpy().copy() for t in tree_leaves(
                tr.gathered_params(state))],
            "local_shard_diff": shard_diff,
            "held_bytes": held_state_bytes(tr, params, batches[0]),
            "dryrun_state_bytes": dryrun.held_bytes(dryrun.train_program(
                sc["cfg"], make_abstract_mesh(*TRAINER_MESH, rank=rank),
                ADMMConfig(**sc["admm"]), 2, 16, device="cpu",
                data=batches[0], workers=sc["workers"])[1]),
            "block_round": block_round(tr, single, params, batches,
                                       leaf_ids, tile),
            "block_round_drawn": drawn_block_rounds(sc, mesh, model, params,
                                                    batches)}


#: the block round's draws: bounded delay 1 (depth-2 rings, uniform
#: delays) and a minibatch of half a worker's sequences, on the
#: scenario's N (the split gradient pass: Nl = 2 over model 2) and on
#: half of it (Nl = 1: the owner alone differentiates)
DRAWN = {"split": None, "owner_only": 2}
DRAWN_ADMM = dict(max_delay=1, minibatch=0.5)


def drawn_block_rounds(sc, mesh, model, params, batches):
    """``block_round`` with ``DRAWN_ADMM`` for each case of ``DRAWN``:
    the largest difference from the single-device round, and on the
    scenario's N how far z moved from the undrawn rounds' (the draws
    change the state)."""
    out = {}
    for name, workers in DRAWN.items():
        N = workers or sc["workers"]
        admm = ADMMConfig(**dict(sc["admm"], **DRAWN_ADMM))
        tr, single = (ADMMTrainer(loss_fn=model.loss, admm=admm,
                                  num_workers=N, mesh=m, device="cpu")
                      for m in (mesh, None))
        spec = tr._spec(params)
        rounds = block_round(
            tr, single, params, [{k: v[:N] for k, v in b.items()}
                                 for b in batches],
            spec.space.layout.window_leaf_ids(tr.window(spec)),
            local_tile(spec))
        out[name] = {"diffs_vs_single": rounds["diffs_vs_single"],
                     "tile": local_tile(spec), "last": rounds["steps"][-1]}
    return out


def held_state_bytes(tr, params, batch) -> int:
    """The bytes a rank's trainer holds at init: the storages behind its
    state's leaves (views of its tiles) and the data rows it
    differentiates."""
    state = tr.init(params)
    spec = tr._spec(state.params)
    storages = {}
    for name in ("z_hist", "y", "w_cache"):
        for t in tree_leaves(getattr(state, name)):
            st = t.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    rows = rank_data(local_tile(spec), tr.num_workers, batch)
    return sum(storages.values()) + sum(t.nbytes for t in tree_leaves(rows))


def block_round(tr, single, params, batches, leaf_ids, tile):
    """``train_step_block`` for M rounds (block ``i % M``) from
    ``init(cyclic=True)`` on the mesh and on one device: each round's
    tile leaves, loss and active share, and the largest difference from
    the single-device round's state."""
    state, s_state = tr.init(params, cyclic=True), single.init(
        params, cyclic=True)
    M = tr.admm.num_blocks
    steps, diffs = [], []
    for i in range(M):
        b = batches[i % len(batches)]
        state, info = tr.train_step_block(state, b, i % M)
        s_state, s_info = single.train_step_block(s_state, b, i % M)
        leaves = {name: dict(zip(leaf_ids, (
            t.numpy().copy() for t in tree_leaves(getattr(state, name)))))
            for name in ("z_hist", "y")}
        steps.append(dict(leaves, loss=float(info["loss"]),
                          share=float(info["selected_fraction"])))
        diff = abs(float(info["loss"]) - float(s_info["loss"]))
        for name in ("z_hist", "y"):
            full = tree_leaves(getattr(s_state, name))
            for k, t in leaves[name].items():
                want = full[k].numpy()
                if name == "y":
                    want = want[tile.n0:tile.n0 + tile.Nl]
                diff = max(diff, float(np.abs(t - want).max()))
        diffs.append(diff)
    return {"steps": steps, "diffs_vs_single": diffs,
            "w_cache": state.w_cache}


def run_rank(rank, world, init_method, scenarios_path, out_dir):
    """One rank: the scenarios come from a pickle file, not through the
    spawn's arguments (the start of every process waits until the
    process has read its arguments, so large ones start the ranks one
    after another)."""
    torch.set_num_threads(1)
    scenarios = pickle.loads(Path(scenarios_path).read_bytes())
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        mesh = make_test_mesh(8, 2)
        results = {name: run_scenario(sc, mesh)
                   for name, sc in scenarios.items()
                   if not sc.get("trainer")}
        for name, sc in scenarios.items():
            if sc.get("trainer"):
                results[name] = trainer_scenario(sc, rank)
        ckpt = str(Path(out_dir) / "launch_ckpt")
        results["launch_train"] = launch_train.main(
            ["--mesh", "test", "--ckpt", ckpt] + LAUNCH_ARGS)
        results["launch_ckpt"] = ckpt
        results["errors"] = mesh_errors(mesh, next(iter(scenarios.values())))
        results["coords"] = dict(mesh.coords)
        sc = next(iter(scenarios.values()))
        preset = resolve_mesh("test")
        results["preset"] = {
            "same_mesh": all(m is preset for m in (
                resolve_mesh("test"), session(sc, "test").spec.space.mesh,
                session(sc, "test").problem.mesh)),
            "shape": dict(preset.shape)}
        pod = make_mesh((2, 2, 2), ("pod", "data", "model"))
        results["pod_mesh"] = {
            "coords": dict(pod.coords),
            "worker_shard_index": pod.worker_shard_index,
            "data_group": dist.get_process_group_ranks(pod.data_group),
            "model_group": dist.get_process_group_ranks(pod.model_group)}
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
