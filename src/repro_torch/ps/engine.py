"""SpaceEngine — the PS runtime's bridge to the real variable space.

The runtime's workers and servers execute the SAME ops the vectorized
epoch runs — ``worker_grads`` + ``worker_select_update`` on the worker
side, ``server_consensus_update`` on the server side — so both compute
backends run under the event-driven runtime: on the card the worker
update is the B1 kernel (``csrc/admm_update.cu``) and every block
commit the B2 kernel (``csrc/prox_update.cu``). A recorded trace
replays through ``asybadmm_epoch``, bitwise on the cuda backend and
within fp32 rounding on the plain torch one. Exactness rests on two
properties of those ops:

* **row locality** — every worker-side op is row-independent over the
  leading worker axis, so calling it at the epoch's FULL (N, ...)
  shape with only worker i's row live (zeros elsewhere) yields worker
  i's row bit-identical to the epoch's batched call. The engine never
  slices to N = 1: a batched matmul inside a loss may pick another
  algorithm at another batch size;
* **column locality** — the server reduce+prox on a single block's
  (N, 1, dblk) column equals that block's column of the full-grid
  call (B2 sums over workers in a fixed order per element), so
  lock-free per-block commits are exact.

The engine also owns the epoch's per-round draws, the block split/join
of the consensus representation, and the per-block caches — everything
numeric; the runtime modules own only *time*. The epoch seeds a fresh
generator per ``(spec.seed, t, stream)`` (``device.seeded_generator``),
so the engine keeps no generator chain: round t's selection is the
selector evaluated at full (N, M) on ``(seed, t, _SELECT)``, its
minibatch the subsample drawn from ``(seed, t, _BATCH)``, both on the
spec's device (draws on the CPU differ from draws on the card).

Tensors are never written in place here: every op returns a new
tensor, as the reference's immutable arrays do, so a committed version
or a pulled block can never change under a later round. Where a view
would be fine for reading but pins or aliases a store, the engine
clones (the per-block caches, the push values).

z is an (M, dblk) table and worker bundles are (N, M, dblk) tensors,
so block j is row j: the lock domains' block ids, the per-block caches
and the column-local commits are one code path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.async_sim import subsample_worker_data
from ..core.space import (_BATCH, _SELECT, BLOCK_SELECTORS, ConsensusSpec,
                          SelectorContext)
from ..device import seeded_generator


class SpaceEngine:
    """Numeric services for one :class:`ConsensusSpec`."""

    def __init__(self, spec: ConsensusSpec):
        space = spec.space
        if getattr(space, "mesh", None) is not None:
            # the runtime IS the distribution model; numerics run local
            space = dataclasses.replace(space, mesh=None)
        self.spec = spec
        self.space = space
        self.device = spec.device
        self.N = space.num_workers
        self.M = space.num_blocks
        self.edge = spec.edge.cpu().numpy().astype(bool)
        self.rho_sum = torch.sum(
            torch.where(spec.edge, spec.rho_vec[:, None], 0.0), dim=0)
        # per-block (N, 1) edge columns, contiguous for the commit kernel
        self._edge_cols = [spec.edge[:, j:j + 1].contiguous()
                           for j in range(self.M)]
        self._sel_cache = {}               # t -> (N, M) bool, grad-free only

    # ------------------------------------------------------------------
    # selection + minibatch (the epoch's draws for round t)
    # ------------------------------------------------------------------
    def needs_grads_for_select(self) -> bool:
        """Whether the selector must see real gradient norms. The
        built-in ``random``/``cyclic`` policies are known gradient-free,
        as is any selector carrying a truthy ``gradient_free`` attribute;
        everything else (gauss_southwell, custom registrations) is
        conservatively fed worker i's true grad_sqnorm row — the
        runtime evaluates the selector at full (N, M) shape with only
        that row live, so any selector whose row i depends only on row
        i of grad_sqnorm replays exactly."""
        sel = self.spec.selector
        if getattr(sel, "gradient_free", False):
            return False
        return sel not in (BLOCK_SELECTORS.get("random"),
                           BLOCK_SELECTORS.get("cyclic"))

    def select(self, t: int, i: int, gnorm_row) -> np.ndarray:
        """Worker i's round-t block selection — the epoch's selector on
        the epoch's round-t generator; returns a bool (M,) numpy row.
        Gradient-free selectors depend only on (seed, t), so their full
        (N, M) matrix is computed once per round and served row-wise."""
        if gnorm_row is None:
            cached = self._sel_cache.get(t)
            if cached is None:
                cached = self._sel_cache[t] = self._select_full(t, None, 0)
            return cached[i]
        return self._select_full(t, gnorm_row, i)[i]

    def _select_full(self, t: int, gnorm_row, i: int) -> np.ndarray:
        spec = self.spec
        buf = torch.zeros((self.N, self.M), dtype=torch.float32,
                          device=self.device)
        if gnorm_row is not None:
            buf[i] = gnorm_row
        ctx = SelectorContext(
            rng=seeded_generator(self.device, spec.seed, t, _SELECT),
            edge=spec.edge, t=t, block_fraction=spec.block_fraction,
            grad_sqnorm=lambda: buf)
        return spec.selector(ctx).cpu().numpy()

    def round_data(self, t: int, data):
        """The round-t (possibly minibatched) full-N data — the same
        subsample the epoch's ``worker_grads(minibatch=, rng=)`` draws."""
        if self.spec.minibatch is None:
            return data
        gen = seeded_generator(self.device, self.spec.seed, t, _BATCH)
        return subsample_worker_data(gen, data, self.spec.minibatch)

    # ------------------------------------------------------------------
    # state construction
    # ------------------------------------------------------------------
    def init(self, z0=None):
        """(z0_repr, y, w_cache, x) — Algorithm 1 lines 1-2, the same
        init as ``init_consensus_state`` minus the ring buffer (the
        servers' version lists play that role); x is None unless the
        spec tracks it."""
        space, spec = self.space, self.spec
        z0r = space.init_repr(z0, self.device)
        y = space.zeros_workers(z0r)
        w = space.workers_scaled(z0r, spec.rho_vec)
        x = space.broadcast_workers(z0r) if spec.track_x else None
        return z0r, y, w, x

    # ------------------------------------------------------------------
    # block split / join of the packed consensus representation
    # ------------------------------------------------------------------
    def split_blocks(self, z) -> list:
        """Packed z (M, dblk) -> per-block (dblk,) rows (views: z is
        never written in place)."""
        return [z[j] for j in range(self.M)]

    def join_blocks(self, contents: list):
        """Per-block (dblk,) rows -> a new packed z (M, dblk)."""
        return torch.stack(contents)

    # ------------------------------------------------------------------
    # worker side — epoch-shaped calls with one live row
    # ------------------------------------------------------------------
    def z_tilde_buffer(self, i: int, contents: list):
        """Embed worker i's mixed-version pull (per-block contents) as
        row i of an otherwise-zero full (N, M, dblk) z~ bundle."""
        z_row = self.join_blocks(contents)
        buf = torch.zeros((self.N,) + tuple(z_row.shape), dtype=z_row.dtype,
                          device=z_row.device)
        buf[i] = z_row
        return buf

    def grads(self, z_buf, data):
        """THE epoch gradient call (full-N ``space.worker_grads``) plus
        per-block sq-norms when the selector reads them (else None);
        rows other than the live one are garbage."""
        losses, grad = self.space.worker_grads(self.spec.loss_fn, z_buf,
                                               data)
        gnorm = (self.space.grad_sqnorm(grad)
                 if self.needs_grads_for_select() else None)
        return losses, grad, gnorm

    def update(self, i: int, g_buf, zt_buf, y, w, x, sel_row):
        """THE epoch worker update (full-N ``worker_select_update``)
        with only row i's selection live; returns the new (y, w, x)
        stores. Rows other than i are unselected, so the sel-masked
        writes copy them from the old stores: the outputs already are
        the old stores with row i merged in."""
        spec = self.spec
        sel_buf = torch.zeros((self.N, self.M), dtype=torch.bool,
                              device=self.device)
        sel_buf[i] = torch.tensor(np.asarray(sel_row, bool),
                                  device=self.device)
        return self.space.worker_select_update(
            g_buf, y, zt_buf, w, x, sel_buf, spec.rho_vec, spec.track_x)

    # ------------------------------------------------------------------
    # server side — per-block caches + commits
    # ------------------------------------------------------------------
    def block_cache(self, w_store, j: int):
        """Block j's server-side stale-w~ cache: column j of the packed
        (N, M, dblk) bundle, as its own contiguous (N, dblk) tensor (the
        commit kernel refuses the strided view)."""
        return w_store[:, j].clone(memory_format=torch.contiguous_format)

    def push_value(self, w_store, i: int, j: int):
        """Worker i's fresh w for block j (what a push carries): a copy,
        so a buffered push does not hold the whole store alive."""
        return w_store[i, j].clone()

    def apply_push(self, cache, i: int, value):
        """A new block cache with worker i's row overwritten by a pushed
        w."""
        out = cache.clone()
        out[i] = value
        return out

    def commit_block(self, j: int, z_content, cache):
        """Block j's server update (13) — the REAL
        ``server_consensus_update`` on the block's (N, 1, dblk) column
        (exact vs the full-grid epoch call; see module docstring).
        Returns block j's new (dblk,) content."""
        spec = self.spec
        out = self.space.server_consensus_update(
            z_content[None], cache[:, None, :], self._edge_cols[j],
            self.rho_sum[j:j + 1], spec.gamma, spec.reg)
        return out[0]

