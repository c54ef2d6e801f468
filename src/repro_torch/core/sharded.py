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
from ..launch.mesh import data_axes, model_axis_size, num_workers
from .async_sim import minibatch_rows, validate_minibatch_data
from .space import (_BATCH, _DELAY, _SELECT, ConsensusSpec, ConsensusState,
                    SelectorContext, participation_mask_for,
                    sample_delay_model)


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
    """This rank's tile of an (N workers, M blocks) problem on ``mesh``."""
    msize = model_axis_size(mesh)
    Nl, Ml = N // num_workers(mesh), M // msize
    split = msize > 1 and Nl % msize == 0
    Ng = Nl // msize if split else Nl
    mi = mesh.model_index
    return Tile(n0=mesh.worker_shard_index * Nl, Nl=Nl, m0=mi * Ml, Ml=Ml,
                g0=mi * Ng if split else 0, Ng=Ng)


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
    delays = sample_delay_model(
        spec.delay_model, seeded_generator(dev, spec.seed, t, _DELAY),
        N, M, t)
    z_tilde = space_l.gather(state.z_hist, tile.cols(tile.rows(delays)))

    # --- data: the rows this rank differentiates ((Nl, ...), or (Ng, ...)
    #     under the split gradient pass). The minibatch draw, like the
    #     delay and selection draws, is taken at FULL (N, S) and sliced ---
    data = rank_data(tile, N, data)
    if spec.minibatch is not None:
        shape = validate_minibatch_data(data)
        if shape is not None:
            gen = seeded_generator(dev, spec.seed, t, _BATCH)
            idx = tile.grad_rows(minibatch_rows(gen, N, shape[1],
                                                spec.minibatch))
            rows = torch.arange(tile.Ng, device=idx.device)[:, None]
            data = pytree.tree_map(lambda a: a[rows, idx], data)

    losses, g_cols, gnorm_fn = local_grads(space_l, coll, tile,
                                           spec.loss_fn, z_tilde, data)

    # --- selection at FULL (N, M) on every rank (Gauss-Southwell gathers
    #     the per-block grad norms over the data group) ---
    ctx = SelectorContext(
        rng=seeded_generator(dev, spec.seed, t, _SELECT), edge=edge, t=t,
        block_fraction=spec.block_fraction, grad_sqnorm=gnorm_fn)
    sel = spec.selector(ctx)

    # --- partial participation: the full (N, 1) mask, applied before
    #     slicing ---
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
    return ConsensusState(z_hist=space_l.push(state.z_hist, z_new), y=y,
                          w_cache=w_cache, x=x, t=t + 1), info


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
