"""SPMD-sharded epoch of Algorithm 1 over a (pod, data, model) mesh of
``torch.distributed`` ranks, one process per rank.

Port of ``repro/core/sharded.py``. The paper's Parameter-Server picture
maps onto the mesh directly:

  worker i       = a shard of the ``data`` mesh axes — its duals ``y``,
                   stale-w cache and primal ``x`` live with its data;
  block server j = a shard of the ``model`` axis: the packed (M, dblk)
                   block table (z_hist, the prox and the server kernel)
                   is split over ``model`` into local (M/model, dblk)
                   tiles;
  push w_ij      = a partial edge-masked reduce over the *local* workers
                   followed by ONE all-reduce over the data group that
                   lands directly in each block server's local shard —
                   the full (M, dblk) w_sum never exists on any rank.

Each rank holds local tiles: worker bundles (N/data, M/model, dblk) and
the ring (depth, M/model, dblk). The kernels run on those tiles: the
worker update (B1) and, for the server step, the prox from a reduced
w_sum (B3) — never the fused B2, whose in-kernel reduction cannot span
ranks. Each rank keeps only the data rows it differentiates
(``rank_data``); an epoch given all N workers' rows narrows them. The
measures (residual, P, KKT) complete partial results over the groups
rather than gathering any worker bundle.

Parity contract: the sharded z trajectory equals the single-device
``asybadmm_epoch`` trajectory. Two ingredients make that exact rather
than approximate:

* delay, selection and minibatch draws are taken at FULL (N, M) (or
  (N, S)) shape on every rank from ``seeded_generator(device, seed, t,
  stream)`` and *sliced* to the rank's rows and columns — identical to
  the single-device draw. All ranks of a run must therefore draw on one
  device type (a CUDA and a CPU generator give different streams);
* every elementwise update runs the same math on a slice; only the
  worker reduction's float-sum order changes (partial sum + all-reduce),
  so the two trajectories agree to fp32 tolerance.

Costing one shard (the reference's HLO costing, here the port's cost
counter, ``analysis/cost.py``): every collective of ``MeshCollectives``
reports itself to ``analysis.hooks``, which charges it by kind at its
result's bytes. :class:`SimCollectives` are single-rank stand-ins with
the real collectives' shapes and the same charge, and
:func:`per_shard_cost_program` runs one shard of the epoch on its local
tiles with them, with no process group: on the meta device it costs a
mesh no machine here holds.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..analysis import hooks
from ..device import seeded_generator
from ..launch.mesh import (P, data_axes, model_axis_size, num_workers,
                           shard_slices)
from ..obs.step import step_span
from .admm import server_update, worker_update
from .async_sim import minibatch_rows, validate_minibatch_data
from .space import (_BATCH, _DELAY, _SELECT, ConsensusSpec, ConsensusState,
                    SelectorContext, participation_mask_for,
                    sample_delay_model)
from .tree import tree_map, tree_unflatten

# generator streams of the Gauss-Seidel block round (the epoch's are 0-2)
BLOCK_DELAY, BLOCK_BATCH = 3, 4


def _splits_model(space) -> bool:
    """Does this space shard its block axis over ``model``?"""
    return model_axis_size(space.mesh) > 1


def validate_space_mesh(space) -> None:
    """Eager divisibility checks so a bad (mesh, problem) pairing fails
    with an actionable message, not a shape error inside a collective."""
    mesh = space.mesh
    names = set(mesh.axis_names)
    if not names <= {"pod", "data", "model"}:
        raise ValueError(f"mesh axes {mesh.axis_names} unknown; expected a "
                         f"subset of ('pod', 'data', 'model')")
    nsh = num_workers(mesh)
    if space.num_workers % nsh != 0:
        raise ValueError(
            f"num_workers={space.num_workers} must divide over the mesh's "
            f"{nsh} data-axis shards ({data_axes(mesh)}); pad the worker "
            f"set or pick a smaller mesh")
    if _splits_model(space):
        msize = model_axis_size(mesh)
        if space.num_blocks % msize != 0:
            raise ValueError(
                f"num_blocks={space.num_blocks} must divide over "
                f"model={msize} block-server shards; choose num_blocks as "
                f"a multiple of the model axis (the packed (M, dblk) block "
                f"table is sharded over model)")


def grad_split_size(spec: ConsensusSpec):
    """Workers per rank of the model-split gradient pass, or None when
    grads replicate over model (no model split, or the local worker
    count does not divide by the model axis)."""
    tile = local_tile(spec)
    return tile.Ng if tile.split_grads else None


# ---------------------------------------------------------------------------
# placement specs of every state tensor (the reference's base layout)
# ---------------------------------------------------------------------------

def _model_name(mesh):
    """``"model"`` when the mesh splits the block axis over it, else
    None."""
    return "model" if model_axis_size(mesh) > 1 else None


def worker_bundle_spec(ndim: int, daxes, mname=None) -> P:
    """Worker-bundle leaf: leading N over the data axes, (flat) M over
    model. THE base rule for every (N, ...) ADMM tensor —
    ``launch/shardings.py`` overlays its tensor-parallel param dims on
    top of this."""
    return P(*((daxes, mname) + (None,) * (ndim - 2))[:ndim])


def ring_spec(ndim: int, mname=None) -> P:
    """History leaf: leading ring axis replicated, (flat) M over model."""
    return P(*((None, mname) + (None,) * (ndim - 2))[:ndim])


def consensus_state_specs(spec: ConsensusSpec, state) -> ConsensusState:
    """The placement of every ``ConsensusState`` tensor on the space's
    mesh — THE canonical ADMM state layout (``launch/shardings.py``
    overlays its tensor-parallel param dims on top of it for the dry
    run). A tensor the state lacks (``None``) keeps ``None``."""
    mesh = spec.space.mesh
    daxes, mname = data_axes(mesh), _model_name(mesh)

    def specs(tree, rule):
        return tree_map(lambda a: rule(a.dim()), tree)

    return ConsensusState(
        z_hist=specs(state.z_hist, lambda nd: ring_spec(nd, mname)),
        y=specs(state.y, lambda nd: worker_bundle_spec(nd, daxes, mname)),
        w_cache=specs(state.w_cache,
                      lambda nd: worker_bundle_spec(nd, daxes, mname)),
        x=specs(state.x, lambda nd: worker_bundle_spec(nd, daxes, mname)),
        t=P())


def grad_rows_spec(mesh, split: bool) -> P:
    """Per-worker data: leading worker axis over the data axes, and also
    over ``model`` when the gradient pass splits the local workers across
    it (every rank then holds exactly the rows it differentiates; the
    reference's ``consensus_data_specs``)."""
    daxes = data_axes(mesh)
    return P(daxes + ("model",) if split else daxes)


# ---------------------------------------------------------------------------
# this rank's tile of the (N, M) grid, its data, and the collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Tile:
    """This rank's worker rows [n0, n0 + Nl) and block columns
    [m0, m0 + Ml) of the full (N, M) grid. Of its Nl workers it
    differentiates the Ng from local row g0 on: all of them, unless the
    split gradient pass shares them out over ``model``."""
    n0: int
    Nl: int
    m0: int
    Ml: int
    g0: int
    Ng: int

    @classmethod
    def whole(cls, N: int, M: int) -> "Tile":
        """The one tile of a run with no mesh: every row and column."""
        return cls(n0=0, Nl=N, m0=0, Ml=M, g0=0, Ng=N)

    @property
    def split_grads(self) -> bool:
        return self.Ng < self.Nl

    def rows(self, a):
        return a.narrow(0, self.n0, self.Nl)

    def grad_rows(self, a):
        """The rows, of a full (N, ...) tensor, this rank differentiates."""
        return a.narrow(0, self.n0 + self.g0, self.Ng)

    def cols(self, a, axis: int = 1):
        return a.narrow(axis, self.m0, self.Ml).contiguous()


def tile_for(mesh, N: int, M: int) -> Tile:
    """This rank's tile of an (N workers, M blocks) problem on ``mesh``:
    the shard of an (N, M) worker bundle under :func:`worker_bundle_spec`,
    and of its N data rows under :func:`grad_rows_spec`."""
    (n0, Nl), (m0, Ml) = shard_slices(
        (N, M), worker_bundle_spec(2, data_axes(mesh), _model_name(mesh)),
        mesh)
    msize = model_axis_size(mesh)
    split = msize > 1 and Nl % msize == 0
    (g, Ng), = shard_slices((N,), grad_rows_spec(mesh, split), mesh)
    return Tile(n0=n0, Nl=Nl, m0=m0, Ml=Ml, g0=g - n0, Ng=Ng)


def local_tile(spec: ConsensusSpec) -> Tile:
    return tile_for(spec.space.mesh, spec.space.num_workers,
                    spec.space.num_blocks)


def local_space(spec: ConsensusSpec, Nl: int):
    """The space resized to ``Nl`` local workers, with no mesh."""
    return dataclasses.replace(spec.space, num_workers=Nl, mesh=None)


def rank_data(tile: Tile, N: int, data):
    """``data`` cut to the worker rows this rank differentiates (the
    reference's ``consensus_data_specs``): a leaf holding all N workers'
    rows is narrowed, a leaf already holding this rank's Ng rows is
    kept."""
    def narrow(a):
        if a.shape[0] == N:
            return tile.grad_rows(a)
        if a.shape[0] == tile.Ng:
            return a
        raise ValueError(
            f"sharded epoch: a data leaf needs all N={N} workers' rows or "
            f"this rank's {tile.Ng}; got a leaf of shape {tuple(a.shape)}")
    return pytree.tree_map(narrow, data)


def _gather(x, axis: int, group, size: int):
    """Tiled all-gather: the ranks' ``x`` concatenated along ``axis`` in
    group order (``lax.all_gather(..., tiled=True)``)."""
    def run():
        xm = x.movedim(axis, 0).contiguous()
        out = torch.empty((size * xm.shape[0],) + tuple(xm.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, xm, group=group)
        return out.movedim(0, axis)
    return hooks.collective("all-gather", x, run)


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    def run():
        dist.all_reduce(x, op=op, group=group)
        return x
    return hooks.collective("all-reduce", x, run)


class MeshCollectives:
    """The mesh's collectives, over its data and model groups. The
    reductions work in place on ``x``, which must be a fresh tensor."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.nsh = num_workers(mesh)
        self.msize = model_axis_size(mesh)

    def all_gather_model(self, x, axis):
        return _gather(x, axis, self.mesh.model_group, self.msize)

    def all_to_all_model(self, x, split_axis, concat_axis):
        """``lax.all_to_all(x, "model", split_axis, concat_axis,
        tiled=True)``: chunk k of ``split_axis`` goes to model shard k,
        and the chunks received are concatenated along ``concat_axis`` in
        shard order. ``all_to_all_single`` exchanges dim-0 chunks only,
        so the chunks are stacked on a new leading axis to send, and the
        received stack is moved to its place in front of ``concat_axis``
        (a mix-up here swaps blocks and workers without a shape error)."""
        k = self.msize

        def run():
            chunk = x.shape[split_axis] // k
            send = x.unflatten(split_axis, (k, chunk)).movedim(split_axis, 0)
            send = send.contiguous()             # (k,) + one chunk's shape
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=self.mesh.model_group)
            return recv.movedim(0, concat_axis).flatten(concat_axis,
                                                        concat_axis + 1)
        return hooks.collective("all-to-all", x, run)

    def all_gather_data(self, x):
        return _gather(x, 0, self.mesh.data_group, self.nsh)

    def psum_data(self, x):
        return _all_reduce(x, self.mesh.data_group)

    def psum_model(self, x):
        return _all_reduce(x, self.mesh.model_group)

    def reduce_all(self, x, op=dist.ReduceOp.SUM):
        """``op`` over every rank of the mesh: the data group, then the
        model group."""
        _all_reduce(x, self.mesh.data_group, op)
        return _all_reduce(x, self.mesh.model_group, op)

    def full_blocks(self, x):
        """An (Ml, dblk) block-server shard gathered to the full (M,
        dblk) table."""
        return self.all_gather_model(x, axis=0) if self.msize > 1 else x


class SimCollectives(MeshCollectives):
    """Single-rank stand-ins for :class:`MeshCollectives` with the same
    shapes, for costing one shard with no process group: a gather
    returns its input repeated to the gathered shape, an all-to-all a
    reshape to the exchanged shape, a reduction its input as it is.
    Each reports itself to ``analysis.hooks`` as the real collective
    does, so a counter charges both alike (and counts nothing of the
    stand-in's own ops)."""

    def all_gather_model(self, x, axis):
        return hooks.collective("all-gather", x,
                                lambda: torch.cat([x] * self.msize, axis))

    def all_to_all_model(self, x, split_axis, concat_axis):
        shape = list(x.shape)
        shape[split_axis] //= self.msize
        shape[concat_axis] *= self.msize
        return hooks.collective("all-to-all", x,
                                lambda: x.reshape(shape))

    def all_gather_data(self, x):
        return hooks.collective("all-gather", x,
                                lambda: torch.cat([x] * self.nsh, dim=0))

    def psum_data(self, x):
        return hooks.collective("all-reduce", x, lambda: x)

    def psum_model(self, x):
        return hooks.collective("all-reduce", x, lambda: x)

    def reduce_all(self, x, op=dist.ReduceOp.SUM):
        self.psum_data(x)
        return self.psum_model(x)


def per_shard_cost_program(spec: ConsensusSpec, data, z0=None):
    """(fn, args): ``fn(*args)`` runs ONE shard of the SPMD epoch (the
    tile of the spec's mesh view: rank 0's on an abstract mesh) with
    :class:`SimCollectives`, on local
    tiles made for ``spec.device`` (meta: shapes only), with no process
    group. The mesh may be ``launch.mesh.make_abstract_mesh``'s. ``data``
    holds all N workers' rows or rank 0's; ``z0`` (a params tree, meta
    tensors suffice) is required for a pytree space, which has no
    default initial value. Cost it under ``analysis.cost.count``."""
    from .space import init_consensus_state
    tile = local_tile(spec)
    space_l = local_space(spec, tile.Nl)
    coll = SimCollectives(spec.space.mesh)
    state = init_consensus_state(spec, z0)
    data = rank_data(tile, spec.space.num_workers, data)

    def fn(st, d):
        return _epoch_body(spec, space_l, coll, tile, st, d)

    return fn, (state, data)


def psum_rank_data(mesh, N: int, M: int, x):
    """Complete ``x``, a sum over this rank's data rows (``rank_data``),
    into the sum over all N workers: over the data group, and over the
    model group too when the split gradient pass gave its ranks
    different rows."""
    coll = MeshCollectives(mesh)
    coll.psum_data(x)
    return coll.psum_model(x) if tile_for(mesh, N, M).split_grads else x


def local_grads(space_l, coll, tile: Tile, loss_fn, z_tile, data):
    """Per-worker losses (Nl,) and gradients (Nl, Ml, dblk) of this
    rank's workers at their (Nl, Ml, dblk) tile of points ``z_tile``,
    with ``data`` the rank's rows (``rank_data``), and a thunk of the
    full (N, M) squared gradient norms (Gauss-Southwell's input).

    Grads need every block of the point (the loss reads the whole
    variable). Under the split gradient pass each model shard
    differentiates Ng workers against its all_to_all-routed points (pure
    extra data parallelism), and a second all_to_all routes the grads
    back to the block owners; else every model shard differentiates all
    Nl workers against the all-gathered points."""
    if tile.split_grads:
        # NOT take-then-gather: each model shard holds DIFFERENT blocks,
        # so gathering the Ng rows would stitch chunk m's blocks onto
        # chunk m's workers. The all_to_all routes every shard's block
        # slice of the destination's worker rows — the exact inverse of
        # the gradient exchange below.
        zt_g = coll.all_to_all_model(z_tile, 0, 1)    # (Ng, M, dblk)
        space_g = dataclasses.replace(space_l, num_workers=tile.Ng)
        losses_g, g_g = space_g.worker_grads(loss_fn, zt_g, data)
        losses = coll.all_gather_model(losses_g, axis=0)
        g_cols = coll.all_to_all_model(g_g, 1, 0)     # (Nl, Ml, dblk)
        return losses, g_cols, lambda: coll.all_gather_data(
            coll.all_gather_model(space_g.grad_sqnorm(g_g), axis=0))
    z_full = (coll.all_gather_model(z_tile, axis=1) if coll.msize > 1
              else z_tile)
    losses, g = space_l.worker_grads(loss_fn, z_full, data)
    return losses, tile.cols(g), lambda: coll.all_gather_data(
        space_l.grad_sqnorm(g))


def rank_minibatch(spec: ConsensusSpec, tile: Tile, data, t: int,
                   stream: int):
    """The incremental workers' subsample of ``data``, the rank's rows
    (``rank_data``): the draw is taken at FULL (N, S) from ``(spec.seed,
    t, stream)`` and sliced to the rows, as the single-device
    ``subsample_worker_data`` draws it."""
    if spec.minibatch is None:
        return data
    shape = validate_minibatch_data(data)
    if shape is None:
        return data
    gen = seeded_generator(spec.device, spec.seed, t, stream)
    idx = tile.grad_rows(minibatch_rows(gen, spec.space.num_workers,
                                        shape[1], spec.minibatch))
    rows = torch.arange(tile.Ng, device=idx.device)[:, None]
    return pytree.tree_map(lambda a: a[rows, idx], data)


# ---------------------------------------------------------------------------
# the per-rank epoch body (Algorithm 1, local view)
# ---------------------------------------------------------------------------

def _epoch_body(spec: ConsensusSpec, space_l, coll, tile: Tile,
                state: ConsensusState, data
                ) -> Tuple[ConsensusState, dict]:
    """One epoch on ONE rank. ``space_l`` is the space resized to the
    local worker count (num_workers=Nl, mesh=None); the worker bundles in
    ``state`` are local (Nl, Ml, dblk) tiles; ``spec.edge`` /
    ``spec.rho_vec`` are the full (N, M) / (N,) on every rank."""
    edge, rho_vec = spec.edge, spec.rho_vec
    N, M = edge.shape
    dev, t = spec.device, state.t

    # --- stale pull: FULL (N, M) draw on every rank, sliced to the tile ---
    with step_span("asybadmm.gather"):
        delays = sample_delay_model(
            spec.delay_model, seeded_generator(dev, spec.seed, t, _DELAY),
            N, M, t)
        z_tilde = space_l.gather(state.z_hist, tile.cols(tile.rows(delays)))

    # --- data: the rows this rank differentiates ((Nl, ...), or (Ng, ...)
    #     under the split gradient pass). The minibatch draw, like the
    #     delay and selection draws, is taken at FULL (N, S) and sliced ---
    data = rank_minibatch(spec, tile, rank_data(tile, N, data), t, _BATCH)

    losses, g_cols, gnorm_fn = local_grads(space_l, coll, tile,
                                           spec.loss_fn, z_tilde, data)

    # --- selection at FULL (N, M) on every rank (Gauss-Southwell gathers
    #     the per-block grad norms over the data group) ---
    with step_span("asybadmm.select"):
        ctx = SelectorContext(
            rng=seeded_generator(dev, spec.seed, t, _SELECT), edge=edge,
            t=t, block_fraction=spec.block_fraction, grad_sqnorm=gnorm_fn)
        sel = spec.selector(ctx)

        # --- partial participation: the full (N, 1) mask, applied
        #     before slicing ---
        pmask = participation_mask_for(spec.delay_model, t, dev)
        if pmask is not None:
            sel = sel & pmask

    # --- worker update (11)(12)(9) + select writes on the local tile ---
    y, w_cache, x = space_l.worker_select_update(
        g_cols, state.y, z_tilde, state.w_cache, state.x,
        tile.cols(tile.rows(sel)), tile.rows(rho_vec), spec.track_x)

    # --- the paper's w push: partial edge-masked reduce over the LOCAL
    #     workers, then one all-reduce over data that lands in this block
    #     server's shard ---
    w_sum = coll.psum_data(space_l.reduce_workers(
        w_cache, tile.cols(tile.rows(edge))))
    rho_sum = tile.cols(torch.sum(torch.where(edge, rho_vec[:, None], 0.0),
                                  dim=0), axis=0)
    z_new = space_l.server_prox(space_l.current(state.z_hist), w_sum,
                                rho_sum, spec.gamma, spec.reg)

    loss = coll.psum_data(torch.sum(losses)) / N
    info = {"loss": loss,
            "selected_fraction": torch.mean(sel.to(torch.float32))}
    with step_span("asybadmm.push"):
        z_hist = space_l.push(state.z_hist, z_new)
    return ConsensusState(z_hist=z_hist, y=y, w_cache=w_cache, x=x,
                          t=t + 1), info


# ---------------------------------------------------------------------------
# the Gauss-Seidel block round (ADMMTrainer.train_step_block), local view
# ---------------------------------------------------------------------------

def block_round_body(spec: ConsensusSpec, coll, tile: Tile, z_hist, y,
                     t: int, data, block_id: int):
    """One cyclic (Gauss-Seidel) round of block ``block_id`` on ONE rank:
    every worker updates that block, and nothing else changes. The
    paper's §3.2 alternative block selection, ``ADMMTrainer``'s
    ``train_step_block``, on the packed table.

    ``z_hist`` (D+1, Ml, dblk) and ``y`` (Nl, Ml, dblk) are the rank's
    tiles (with no mesh, ``tile`` is :meth:`Tile.whole` and ``coll`` is
    None); there is no w cache, which the round never reads. Returns
    (z_hist, y, losses' mean, the active leaves' share); the tiles of a
    rank that does not own the block come back as they were (the same
    tensors), and the owner's are new tables, its inputs' copies with
    column b replaced: the trainer hands the round its state's own
    tables.

    The design, the epoch's (``_epoch_body``) cut to one block:

    * the stale pull draws its delays at FULL (N, M) from the round's own
      stream (``BLOCK_DELAY``) and slices them to the tile; the
      minibatch likewise (``BLOCK_BATCH``), so every rank sees the
      single-device draw;
    * the gradient of block b's leaves only, at points gathered over
      model (the parameter-gradient products of the frozen leaves are
      never built). Under the split gradient pass every model rank
      differentiates its share of the rows at all_to_all-routed points,
      as ``local_grads`` routes them, and the gradients are gathered to
      the owner; otherwise the owner alone differentiates its rows at
      the all-gathered points, and the other model ranks only take part
      in the gather;
    * on the model rank that owns block b (its block server): the worker
      update (11)(12)(9) of its rows, edge-masked, block b's worker sum
      completed over the data group by ONE all-reduce, and the server
      prox (13) pushed into block b's column of the ring. The update
      equations are the plain ``core.admm`` ones, as in the reference:
      the round launches no kernel;
    * the loss: each rank's sum over the rows it differentiated (0 where
      it took no gradient), completed over the mesh.
    """
    edge, rho_vec = spec.edge, spec.rho_vec
    N, M = edge.shape
    dev = spec.device
    layout = spec.space.packer
    split = coll is not None and tile.split_grads
    j = block_id - tile.m0
    owner = 0 <= j < tile.Ml                   # block b's server

    with step_span("asybadmm.gather"):
        delays = sample_delay_model(
            spec.delay_model,
            seeded_generator(dev, spec.seed, t, BLOCK_DELAY), N, M, t)
        z_tilde = spec.space.gather(z_hist, tile.cols(tile.rows(delays)))
    data = rank_minibatch(spec, tile, rank_data(tile, N, data), t,
                          BLOCK_BATCH)

    # --- the points of the rows this rank differentiates, every block ---
    if split:
        points = coll.all_to_all_model(z_tilde, 0, 1)     # (Ng, M, dblk)
    elif coll is not None and coll.msize > 1:
        points = coll.all_gather_model(z_tilde, axis=1)   # (Nl, M, dblk)
    else:
        points = z_tilde
    del z_tilde
    if not (owner or split):          # the gather was all this rank owed
        loss = coll.reduce_all(torch.zeros((), device=points.device)) / N
        del points
        return z_hist, y, loss, _active_share(layout, block_id)
    with step_span("asybadmm.unpack"):
        leaves = layout.unpack_leaves(points)
    del points
    active_idx = layout.window_leaf_ids((block_id, 1))
    treedef = layout.tree.treedef

    def loss_from_active(active_leaves, all_leaves, d):
        merged = list(all_leaves)
        for i, leaf in zip(active_idx, active_leaves):
            merged[i] = leaf
        return spec.loss_fn(tree_unflatten(treedef, merged), d)

    with step_span("asybadmm.loss"):
        g_active, losses = torch.func.vmap(
            torch.func.grad_and_value(loss_from_active))(
                [leaves[i] for i in active_idx], leaves, data)
    del leaves
    with step_span("asybadmm.pack"):
        g = (layout.pack_leaves(list(g_active), (block_id, 1))[:, 0]
             if active_idx else torch.zeros(
                 (losses.shape[0], layout.block_dim), device=losses.device))
    del g_active
    if split:                                  # rows back to their owner
        g = coll.all_gather_model(g, axis=0)
        losses = coll.all_gather_model(losses, axis=0)
    if coll is None:
        loss = torch.mean(losses)
    elif split:
        loss = coll.psum_data(torch.sum(losses)) / N
    else:                                      # the owner's rows only
        loss = coll.reduce_all(torch.sum(losses)) / N

    if owner:
        rho = tile.rows(rho_vec).float()[:, None]
        e = tile.rows(edge[:, block_id])[:, None]
        y_j = y[:, j]
        # block b's column of z~, gathered again: kept through the
        # backward it would add its bytes to the round's peak
        zt_j = z_hist[tile.rows(delays)[:, block_id], j]
        # each (Nl, dblk) temporary is dropped once read: the new tables
        # below are made at the round's end, beside the caller's state
        y_new, w_new = worker_update(g.float(), y_j, zt_j, rho)[1:]
        del g, zt_j
        w_sum = torch.sum(torch.where(e, w_new, 0.0), dim=0)
        del w_new
        if coll is not None:
            w_sum = coll.psum_data(w_sum)
        rho_sum = torch.sum(torch.where(edge[:, block_id], rho_vec.float(),
                                        0.0))
        z_new = server_update(z_hist[0, j], w_sum, rho_sum, spec.gamma,
                              spec.reg.prox)
        col = torch.tensor([j], device=y.device)
        y_col = torch.where(e, y_new, y_j).to(y.dtype)
        del y_new
        # new tables, column b replaced out of place (one copy each)
        y = y.index_copy(1, col, y_col[:, None])
        del y_col
        z_hist = z_hist.index_copy(1, col, torch.cat(
            [z_new[None].to(z_hist.dtype), z_hist[:-1, j]])[:, None])
    return z_hist, y, loss, _active_share(layout, block_id)


def _active_share(layout, block_id: int) -> float:
    """The share of the leaves that block ``block_id`` holds."""
    return (len(layout.window_leaf_ids((block_id, 1)))
            / max(len(layout.block_ids), 1))


def per_shard_block_round_program(spec: ConsensusSpec, data, z0,
                                  block_id: int = 0):
    """(fn, args): ``fn(*args)`` runs ONE shard of the block round of
    ``block_id`` (:func:`block_round_body`; the tile of the spec's mesh
    view) with :class:`SimCollectives`, on local tiles made for
    ``spec.device``, with no process group: z_hist and y, no w cache,
    as ``ADMMTrainer.init(cyclic=True)`` holds them. Cost it under
    ``analysis.cost.count``."""
    from .space import init_consensus_state
    tile = local_tile(spec)
    coll = SimCollectives(spec.space.mesh)
    state = init_consensus_state(spec, z0)
    data = rank_data(tile, spec.space.num_workers, data)

    def fn(z_hist, y, d):
        return block_round_body(spec, coll, tile, z_hist, y, 0, d, block_id)

    return fn, (state.z_hist, state.y, data)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def sharded_epoch(spec: ConsensusSpec, state: ConsensusState, data
                  ) -> Tuple[ConsensusState, dict]:
    """``asybadmm_epoch`` over the space's mesh: this rank's share."""
    tile = local_tile(spec)
    return _epoch_body(spec, local_space(spec, tile.Nl),
                       MeshCollectives(spec.space.mesh), tile, state, data)


def full_z_blocks(spec: ConsensusSpec, state: ConsensusState):
    """The newest (M, dblk) consensus table, the model shards gathered;
    the same on every rank."""
    if spec.space.mesh is None:
        return state.z_blocks
    return MeshCollectives(spec.space.mesh).full_blocks(state.z_blocks)


def consensus_residual(spec: ConsensusSpec, state: ConsensusState):
    """``space.consensus_residual`` of a sharded state, from this rank's
    w-cache tile: the worker mean is a partial sum completed over the
    data group, the dispersion a partial sum completed over the mesh.
    The same value on every rank."""
    coll = MeshCollectives(spec.space.mesh)
    N = spec.space.num_workers
    w32 = state.w_cache.to(torch.float32)
    mean = coll.psum_data(torch.sum(w32, dim=0)) / N    # this shard's blocks
    num = coll.reduce_all(torch.sum(torch.square(w32 - mean[None])))
    den = coll.psum_model(torch.sum(torch.square(mean))) * N
    return torch.sqrt(num / torch.clamp_min(den, 1e-12))
