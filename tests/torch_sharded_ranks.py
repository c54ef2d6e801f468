"""Rank side of ``tests/test_torch_sharded.py``.

``run_rank`` is one process of a gloo process group on the CPU: it
builds the (data=4, model=2) test mesh, runs every scenario it is given
through ``ConsensusSession.flat(..., mesh=mesh)`` (a scenario marked
``tree`` through ``ConsensusSession.pytree``: one leaf per block, its
centers the batch), checks the mesh
errors and the groups of a (pod, data, model) mesh, and pickles what it
saw to ``out_dir/rank<r>.pkl``. It imports
torch and the port only, so the spawned ranks never load JAX; scenarios
arrive as numpy arrays and plain values.
"""
import datetime
import pickle
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import ConsensusSession
from repro_torch.configs.base import ADMMConfig
from repro_torch.core import space
from repro_torch.core.blocks import TreeBlocks
from repro_torch.core.sharded import grad_split_size
from repro_torch.core.tree import tree_structure
from repro_torch.launch.mesh import make_mesh, make_test_mesh, resolve_mesh

PG_TIMEOUT_S = 60


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


def run_rank(rank, world, init_method, scenarios, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        mesh = make_test_mesh(8, 2)
        results = {name: run_scenario(sc, mesh)
                   for name, sc in scenarios.items()}
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
