"""Trainers, a port of ``repro/training/trainer.py``.

``ADMMTrainer`` — AsyBADMM as a distributed-training feature (pytree
mode), a thin adapter: the delay gather, block selection, worker update
and server prox all route through ``core.space.TreeSpace`` and the
shared ``core.space.asybadmm_epoch``, the implementation the flat driver
and ``ConsensusSession.pytree`` use, so the trainer honours every
``ADMMConfig`` policy (``block_selection`` random / cyclic /
gauss_southwell / zipf), heterogeneous per-worker ``rho_scale`` and an
optional general-form ``edge`` set. On the card ``train_step`` runs the
epoch's two kernels, B1 (the worker update with its sel-masked merges)
and B2 (the edge-masked reduce and the prox), once a step.

The state stays params-shaped, as the reference's: ``train_step`` packs
it onto the (N, M, dblk) block table, runs the epoch and unpacks the
result. An unpacked f32 leaf is a view of its table, so a state that
``train_step`` or ``init`` returned packs back with no copy: the step
finds the table behind its leaves. A state built any other way (a
restored checkpoint) is packed by a copy. The spec (layout, edge set,
penalties, policies) is built once per trainer and tree structure: the
reference leans on ``jit``'s cache for that, and an eager rebuild would
be host work on every step.

Under a mesh (``mesh=``, or ``admm.mesh``) ``train_step`` runs the SPMD
epoch of ``core/sharded.py`` (B1 and B3 on every rank, never B2) and
``train_step_block`` the block round there (``block_round_body``), and
each rank's state holds only its tile of the (N, M) grid: the ring's
block columns [m0, m0 + Ml) and the duals and w cache of its worker rows
[n0, n0 + Nl) in those columns (``core.sharded.local_tile``). It is
still params-shaped: a leaf lies in one block, so the tile unpacks into
the leaves of the rank's blocks (``BlockLayout``'s block window
(m0, Ml); ``z_hist`` leaves (D+1, ...), ``y`` /
``w_cache`` leaves (Nl, ...)), views of the tile, and every other leaf
of the tree is ``None``. No rank holds the whole table, so the state's
memory divides over the mesh; ``gathered_params`` gathers the newest z
over the model axis into the full params tree.

``SGDTrainer`` — the conventional synchronous data-parallel baseline
(mean gradient + AdamW/SGD), for the convergence comparisons.

Every draw comes from a generator seeded from ``(admm.seed, step,
stream)``: ``train_step`` uses the epoch's streams, ``train_step_block``
streams of its own (the reference splits its own key chain there).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ADMMConfig
from ..core.blocks import (BlockLayout, TreeBlocks, make_block_layout,
                           make_tree_blocks)
from ..core.sharded import (MeshCollectives, Tile, block_round_body,
                            full_z_blocks, local_tile)
from ..core.space import (ConsensusSpec, ConsensusState, TreeSpace,
                          asybadmm_epoch, consensus_residual,
                          init_consensus_state, make_spec)
from ..core.tree import tree_flatten, tree_leaves
from ..device import DeviceLike
from ..obs.step import step_span
from ..optim.optimizers import Optimizer, apply_updates
from .train_state import ADMMTrainState, SGDTrainState

# ===========================================================================
# baseline: synchronous data-parallel SGD/Adam
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class SGDTrainer:
    loss_fn: Callable            # loss_fn(params, batch) -> scalar
    optimizer: Optimizer

    def init(self, params) -> SGDTrainState:
        return SGDTrainState(params=params,
                             opt_state=self.optimizer.init(params), step=0)

    def train_step(self, state: SGDTrainState, batch
                   ) -> Tuple[SGDTrainState, Dict]:
        grads, loss = torch.func.grad_and_value(self.loss_fn)(state.params,
                                                              batch)
        updates, opt_state = self.optimizer.update(grads, state.opt_state,
                                                   state.params)
        del grads                    # the gradient's memory, before the sum
        params = apply_updates(state.params, updates)
        return (SGDTrainState(params, opt_state, int(state.step) + 1),
                {"loss": loss})


# ===========================================================================
# AsyBADMM consensus trainer — thin adapter over core.space
# ===========================================================================

def _table(layout: BlockLayout, window, tree):
    """The block table (a block ``window``'s rows) behind a params-shaped
    tree: the table itself when every leaf is still the view
    ``layout.from_blocks`` made of it (so a step's output packs with no
    copy), else a packed copy."""
    leaves = tree_leaves(tree)
    base = leaves[0]._base
    lead = leaves[0].dim() - len(
        layout.leaf_shapes[layout.window_leaf_ids(window)[0]])
    shape = tuple(leaves[0].shape[:lead]) + (layout.window_rows(window),
                                             layout.block_dim)
    if base is not None and base.dtype == torch.float32 \
            and base.is_contiguous() and base.numel() == torch.Size(
                shape).numel() \
            and all(leaf._base is base and leaf.dtype == torch.float32
                    for leaf in leaves):
        table = base.view(shape)
        if all(leaf.data_ptr() == view.data_ptr()
               and leaf.shape == view.shape and leaf.stride() == view.stride()
               for leaf, view in zip(leaves, layout.unpack_leaves(table,
                                                                  window))):
            return table
    return layout.to_blocks(tree, window)


def _tree_key(tree):
    leaves, treedef = tree_flatten(tree)
    return (treedef, tuple((tuple(leaf.shape), leaf.dtype)
                           for leaf in leaves))


@dataclasses.dataclass(frozen=True)
class ADMMTrainer:
    """Block-wise asynchronous consensus training over a params pytree.

    loss_fn(params, worker_batch) -> scalar — per-worker loss; batches
    carry a leading worker axis N.

    edge      : optional (N, M) bool — the paper's general-form edge set
                E; worker i only touches blocks j with edge[i, j].
    rho_scale : optional (N,) — heterogeneous per-worker penalties,
                effective rho_i = admm.rho * rho_scale[i].
    mesh      : optional ``launch.mesh.Mesh`` (or preset name)
                overriding ``admm.mesh``: ``train_step`` then runs the
                SPMD epoch, and each rank's state is its tile (see the
                module's docstring).
    device    : where the state lives and the epoch runs (None: the card).
    """
    loss_fn: Callable
    admm: ADMMConfig
    num_workers: int
    blocks: Optional[TreeBlocks] = None
    edge: Optional[Any] = None
    rho_scale: Optional[Any] = None
    mesh: Optional[Any] = None
    device: DeviceLike = None

    def __post_init__(self):
        # specs by tree structure, leaf shapes and dtypes (the full
        # params tree's, and under a mesh its tile's too)
        object.__setattr__(self, "_specs", {})

    def _spec(self, params) -> ConsensusSpec:
        key = _tree_key(params)
        spec = self._specs.get(key)
        if spec is None:
            blocks = self.blocks if self.blocks is not None \
                else make_tree_blocks(params, self.admm.num_blocks)
            space = TreeSpace(blocks=blocks, num_workers=self.num_workers,
                              layout=make_block_layout(params, blocks))
            spec = make_spec(space, self.admm, self.loss_fn, edge=self.edge,
                             rho_scale=self.rho_scale, track_x=False,
                             mesh=self.mesh, device=self.device)
            self._specs[key] = spec
        return spec

    @staticmethod
    def window(spec):
        """This rank's block columns (m0, Ml) under a mesh, else None
        (every block)."""
        if spec.space.mesh is None:
            return None
        tile = local_tile(spec)
        return (tile.m0, tile.Ml)

    def _packed(self, spec, state: ADMMTrainState) -> ConsensusState:
        layout, window = spec.space.layout, self.window(spec)
        return ConsensusState(z_hist=_table(layout, window, state.z_hist),
                              y=_table(layout, window, state.y),
                              w_cache=_table(layout, window, state.w_cache),
                              x=None, t=int(state.step))

    def _state(self, spec, g: ConsensusState) -> ADMMTrainState:
        layout, window = spec.space.layout, self.window(spec)
        state = ADMMTrainState(z_hist=layout.from_blocks(g.z_hist, window),
                               y=layout.from_blocks(g.y, window),
                               w_cache=layout.from_blocks(g.w_cache, window),
                               step=g.t)
        if window is not None:
            # a tile's tree is found by its own structure from here on
            self._specs.setdefault(_tree_key(state.params), spec)
        return state

    def gathered_params(self, state: ADMMTrainState):
        """The newest consensus params as the full params tree, on every
        rank (under a mesh, the z tiles gathered over the model axis)."""
        spec = self._spec(state.params)
        if spec.space.mesh is None:
            return state.params
        z = full_z_blocks(spec, self._packed(spec, state))
        return spec.space.layout.from_blocks(z)

    @staticmethod
    def _check_w_cache(state: ADMMTrainState, what: str) -> None:
        if isinstance(state.w_cache, tuple) and state.w_cache == ():
            raise ValueError(
                f"state was built with init(cyclic=True), which drops the "
                f"w cache {what}")

    def init(self, params, *, cyclic: bool = False) -> ADMMTrainState:
        spec = self._spec(params)
        # the trainer's user-facing state stays in PARAMS representation
        # (leaf dtypes, checkpoints; under a mesh the rank's tile);
        # train_step lowers it onto the packed block table per step
        state = self._state(spec, init_consensus_state(spec, params))
        if cyclic:
            # Static Gauss-Seidel rounds (train_step_block) never read the
            # stale-w cache (every worker pushes the active block fresh) —
            # don't carry it.
            state = state._replace(w_cache=())
        return state

    # -----------------------------------------------------------------
    def train_step(self, state: ADMMTrainState, batch
                   ) -> Tuple[ADMMTrainState, Dict]:
        """One AsyBADMM epoch across all N workers (Alg. 1, both roles),
        delegated to the shared generic step.

        batch: pytree with leading axes (N, per_worker_batch, ...).
        """
        self._check_w_cache(
            state, "and only supports train_step_block; for the dynamic "
                   "block_selection='cyclic' policy use a plain "
                   "init(params)")
        with step_span("admm.train_step"):
            spec = self._spec(state.params)
            g, info = asybadmm_epoch(spec, self._packed(spec, state), batch)
            return self._state(spec, g), info

    # -----------------------------------------------------------------
    def train_step_block(self, state: ADMMTrainState, batch, block_id: int
                         ) -> Tuple[ADMMTrainState, Dict]:
        """Cyclic (Gauss-Seidel) block round: ALL workers update block
        ``block_id`` this step (the paper's §3.2 alternative block
        selection); drive it with ``step % num_blocks``.

        * gradients are taken w.r.t. the active leaves only — the
          parameter-gradient products of frozen leaves are never built;
        * the cross-worker reduction (the paper's w push) covers only
          the active block;
        * the server-side stale-w cache is never read (every worker
          pushes the active block fresh), so it is not carried at all.

        The round runs on the packed table (``core.sharded.
        block_round_body``, whose docstring states the design). Under a
        mesh each rank runs it on its tile — the gradient at points
        gathered over ``model``, block b's worker sum one all-reduce over
        the data group, the prox on the model rank that owns block b —
        and gets its tile of the single-device round's state. The update
        equations and server prox are the plain ``core.admm`` ones, as in
        the reference: this path launches no kernel. Its delay and
        minibatch draws come from streams of its own.
        """
        with step_span("admm.train_step"):
            spec = self._spec(state.params)
            layout, window = spec.space.layout, self.window(spec)
            if spec.space.mesh is None:
                tile, coll = Tile.whole(self.num_workers,
                                        self.admm.num_blocks), None
            else:
                tile, coll = local_tile(spec), MeshCollectives(spec.space.mesh)
            t = int(state.step)
            with step_span("asybadmm.epoch"):
                z_hist, y, loss, share = block_round_body(
                    spec, coll, tile, _table(layout, window, state.z_hist),
                    _table(layout, window, state.y), t, batch, block_id)
            info = {"loss": loss,
                    "selected_fraction": torch.tensor(share,
                                                      device=spec.device)}
            return (ADMMTrainState(
                z_hist=layout.from_blocks(z_hist, window),
                y=layout.from_blocks(y, window),
                w_cache=state.w_cache,    # untouched (never read in cyclic)
                step=t + 1), info)

    # -----------------------------------------------------------------
    def consensus_residual(self, state: ADMMTrainState) -> torch.Tensor:
        """||x_i - z||/||z|| proxy: since x = z~-(g+y')/rho and y' = -g at
        update time, the dual drift ||y_i + g_i|| collapses; we report the
        w-cache dispersion across workers instead (0 at consensus)."""
        self._check_w_cache(
            state, "the consensus residual is computed from; use a plain "
                   "init(params) to track it")
        spec = self._spec(state.params)
        return consensus_residual(spec, self._packed(spec, state))
