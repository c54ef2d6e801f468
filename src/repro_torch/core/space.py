"""The variable spaces and one epoch of Algorithm 1, in torch.

Port of ``repro/core/space.py``. A space owns the mechanics of the
paper's Algorithm 1 on the packed (M, dblk) block table
(bounded-staleness history, gather, per-worker gradients, worker and
server updates), behind two interchangeable codecs of the user's
representation:

* ``FlatSpace`` — a flat vector, blocked by
  :class:`~repro_torch.core.blocks.FlatBlocks` (the paper's workloads);
* ``TreeSpace`` — a params pytree, its leaves assigned to blocks by
  :class:`~repro_torch.core.blocks.TreeBlocks` and packed into the same
  table by :class:`~repro_torch.core.blocks.BlockLayout` (consensus
  training). Packing touches only the epoch's boundary (the z~ unpack
  and the gradient repack in ``worker_grads``): the kernels, the SPMD
  block servers and the PS lock domains see the one table.

On top of the space sit two pluggable policies, block selection (a
registry: ``random``, ``cyclic``, ``zipf``, ``gauss_southwell``, or any
callable) and the delay model (Assumption 3).

Each space carries a **compute backend** for the epoch's elementwise hot
path, resolved from ``"auto"`` by :func:`resolve_backend`:

* ``torch`` — the plain composition (worker update, three sel-masked
  merges, edge-masked reduce, prox), the counterpart of the reference's
  ``jnp``; it runs on any device;
* ``cuda``  — the hand-written kernels in ``kernels/`` (``csrc/*.cu``):
  one pass over the (N, M, dblk) worker bundles for update (11)(12)(9)
  plus the select writes, and a server kernel that reduces over workers
  in registers, so ``w_sum`` never reaches device memory. Proxes outside
  the l1+box family keep the server step on the plain path.

Each space also optionally carries a **mesh** (``mesh=`` on
``ADMMConfig`` / ``ConsensusSession`` / :func:`make_spec`: a
``launch.mesh.Mesh`` of ``torch.distributed`` ranks or a preset name).
When set, ``asybadmm_epoch`` runs the SPMD epoch of ``core/sharded.py``
on this rank's share: worker bundles split ``(data, model)`` over their
leading (N, M) axes, the z ring split over ``model``, the paper's w push
an all-reduce over the data ranks that lands in each block server's
local shard, whose prox then runs the prox-only kernel.

Randomness: every epoch draws from generators seeded from
``(spec.seed, state.t, stream)`` (``device.seeded_generator``), so the
draws of an epoch depend only on the seed and the epoch counter, and the
state stays a plain immutable tuple. The reference draws from JAX's
threefry, which torch cannot reproduce; parity with it runs at settings
that draw nothing, or with draws injected through :class:`TraceDelay`
and a callable selector.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Protocol, Tuple)

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, seeded_generator
from ..kernels import ops as kernel_ops
from ..obs.step import step_span
from .admm import server_update, worker_update
from .async_sim import (gather_delayed, gumbel, push_history, sample_delays,
                        select_blocks, subsample_worker_data)
from .blocks import FlatBlocks, TreeBlocks
from .prox import Regularizer, make_prox
from .tree import tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# compute backends (the epoch's elementwise hot path)
# ---------------------------------------------------------------------------

BACKENDS = ("torch", "cuda")


def resolve_backend(backend: Optional[str] = None,
                    device: DeviceLike = "cpu") -> str:
    """Resolve a space compute backend name for ``device``.

    ``"auto"``/None picks ``cuda`` (the hand-written kernels) on a CUDA
    device and ``torch`` elsewhere. ``"cuda"`` off a CUDA device raises:
    there is no kernel to launch on the CPU. On the meta device it is the
    card's program with shapes only (the kernels' plain versions run
    there; ``analysis/cost.py`` charges each its declared cost).
    ``"torch"`` runs anywhere.
    """
    dev = torch.device(device)
    if backend in (None, "auto"):
        return "cuda" if dev.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"expected one of torch | cuda | auto")
    if backend == "cuda" and dev.type not in ("cuda", "meta"):
        raise ValueError(f"backend='cuda' launches the CUDA kernels and "
                         f"needs a CUDA device; got device={dev}")
    return backend


# ---------------------------------------------------------------------------
# delay models (Assumption 3 hook)
# ---------------------------------------------------------------------------

class DelayModel(Protocol):
    """How per-(worker, block) staleness tau_ij is drawn each epoch."""

    @property
    def depth(self) -> int:
        """Ring-buffer depth the history must keep (max delay + 1)."""

    def sample(self, gen: torch.Generator, n_workers: int, n_blocks: int,
               *, t=None) -> torch.Tensor:
        """Return (N, M) int64 delays in [0, depth) on ``gen.device``.
        ``t`` is the epoch counter — stochastic models ignore it,
        :class:`TraceDelay` indexes its recorded trace with it."""


def sample_delay_model(dm, gen, n_workers: int, n_blocks: int, t):
    """Call ``dm.sample`` passing the epoch counter, tolerating custom
    models whose ``sample`` signature has no ``t=`` keyword (detected by
    signature inspection, so a TypeError raised INSIDE a t-aware model
    still surfaces)."""
    try:
        params = inspect.signature(dm.sample).parameters
        has_t = "t" in params or any(
            p.kind is inspect.Parameter.VAR_KEYWORD
            for p in params.values())
    except (TypeError, ValueError):        # builtins/partials: assume new
        has_t = True
    if has_t:
        return dm.sample(gen, n_workers, n_blocks, t=t)
    return dm.sample(gen, n_workers, n_blocks)


def participation_mask_for(dm, t, device) -> Optional[torch.Tensor]:
    """(N, 1) bool participation mask for epoch ``t``, or None when the
    delay model has no notion of partial participation (every model but
    :class:`TraceDelay` with recorded absences)."""
    fn = getattr(dm, "participation_mask", None)
    return fn(t, device) if fn is not None else None


@dataclasses.dataclass(frozen=True)
class UniformDelay:
    """tau_ij ~ U{0..max_delay} i.i.d. per epoch."""
    max_delay: int

    @property
    def depth(self) -> int:
        return self.max_delay + 1

    def sample(self, gen, n_workers, n_blocks, *, t=None):
        return sample_delays(gen, n_workers, n_blocks, self.max_delay)


@dataclasses.dataclass(frozen=True)
class ConstantDelay:
    """Every read is exactly ``delay`` epochs stale (worst-case lag)."""
    delay: int

    @property
    def depth(self) -> int:
        return self.delay + 1

    def sample(self, gen, n_workers, n_blocks, *, t=None):
        return torch.full((n_workers, n_blocks), self.delay,
                          dtype=torch.int64, device=gen.device)


@dataclasses.dataclass(frozen=True)
class ParetoDelay:
    """Heavy-tailed straggler staleness, clipped at the history depth:

        tau_ij = clip(floor(Pareto(alpha, x_m=1)) - 1, 0, max_delay)

    Most reads are fresh, but a Pareto tail of (worker, block) pairs
    lags by the full bounded-delay window. Smaller ``alpha`` = heavier
    tail."""
    max_delay: int
    alpha: float = 1.2

    @property
    def depth(self) -> int:
        return self.max_delay + 1

    def sample(self, gen, n_workers, n_blocks, *, t=None):
        if self.max_delay == 0:
            return torch.zeros((n_workers, n_blocks), dtype=torch.int64,
                               device=gen.device)
        u = torch.rand((n_workers, n_blocks), generator=gen,
                       device=gen.device)
        u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
        tau = torch.floor(u ** (-1.0 / self.alpha)) - 1.0
        return torch.clamp(tau, 0, self.max_delay).to(torch.int64)


@dataclasses.dataclass(frozen=True, eq=False)
class TraceDelay:
    """Replay a recorded (rounds, N, M) staleness matrix: ``sample``
    ignores the generator and returns ``delays[t]`` (epochs past the end
    clamp to the final round).

    ``participation`` (optional, (rounds, N) bool) encodes partial
    participation: where False, worker i was absent for round t and
    contributes no edge updates — the epoch ANDs the mask into the
    block-selection matrix. Delay entries of absent rows may be -1
    (unobserved) and are sanitized to 0."""
    delays: Any                       # (rounds, N, M) int array
    participation: Any = None         # (rounds, N) bool, or None = all
    max_delay: int = dataclasses.field(init=False)

    def __post_init__(self):
        d = np.asarray(self.delays, np.int64)
        if d.ndim != 3 or d.shape[0] < 1:
            raise ValueError(f"trace delays must be (rounds, N, M); "
                             f"got shape {d.shape}")
        if self.participation is not None:
            p = np.asarray(self.participation, bool)
            if p.shape != d.shape[:2]:
                raise ValueError(
                    f"participation must be (rounds, N) = {d.shape[:2]}; "
                    f"got shape {p.shape}")
            if d[p].size and d[p].min() < 0:
                raise ValueError("trace contains negative delays for "
                                 "participating (round, worker) entries")
            d = np.where(p[:, :, None], d, 0)
            object.__setattr__(self, "participation", None if p.all() else p)
        elif d.min() < 0:
            raise ValueError("trace contains negative delays")
        object.__setattr__(self, "delays", d)
        object.__setattr__(self, "max_delay", int(d.max()))

    @property
    def num_rounds(self) -> int:
        return self.delays.shape[0]

    @property
    def depth(self) -> int:
        return self.max_delay + 1

    @classmethod
    def load(cls, path) -> "TraceDelay":
        """The delay model of a trace file written by ``DelayTrace.save``
        (this package's or the reference's: one ``.npz`` format)."""
        from ..ps.trace import DelayTrace      # lazy: ps imports core.space
        return DelayTrace.load(path).to_delay_model()

    def _round(self, t) -> int:
        return min(max(int(t), 0), self.num_rounds - 1)

    def participation_mask(self, t, device) -> Optional[torch.Tensor]:
        """(N, 1) bool mask for epoch ``t``, or None at full
        participation."""
        if self.participation is None:
            return None
        return torch.as_tensor(self.participation[self._round(t)][:, None],
                               device=device)

    def sample(self, gen, n_workers, n_blocks, *, t=None):
        if t is None:
            raise ValueError(
                "TraceDelay needs the epoch counter; drive it through "
                "asybadmm_epoch (which passes t=state.t), not directly")
        R, N, M = self.delays.shape
        if (N, M) != (n_workers, n_blocks):
            raise ValueError(
                f"trace was recorded for (N={N}, M={M}) but the epoch "
                f"asks for (N={n_workers}, M={n_blocks})")
        return torch.as_tensor(self.delays[self._round(t)],
                               device=gen.device)


# ---------------------------------------------------------------------------
# block-selection policies (Alg. 1 line 4)
# ---------------------------------------------------------------------------

class SelectorContext(NamedTuple):
    """Everything a selection policy may look at.

    ``rng`` is the epoch's selection generator; ``grad_sqnorm`` is a
    thunk returning the (N, M) per-block squared gradient norms (only
    Gauss-Southwell forces it)."""
    rng: torch.Generator
    edge: torch.Tensor           # (N, M) bool
    t: int                       # epoch counter
    block_fraction: float
    grad_sqnorm: Callable[[], torch.Tensor]


BlockSelector = Callable[[SelectorContext], torch.Tensor]

BLOCK_SELECTORS: Dict[str, BlockSelector] = {}


def register_block_selector(name: str):
    def deco(fn: BlockSelector) -> BlockSelector:
        BLOCK_SELECTORS[name] = fn
        return fn
    return deco


def resolve_block_selector(sel) -> BlockSelector:
    if callable(sel):
        return sel
    try:
        return BLOCK_SELECTORS[sel]
    except KeyError:
        raise ValueError(
            f"unknown block_selection {sel!r}; "
            f"registered: {sorted(BLOCK_SELECTORS)}") from None


def _top_k(block_fraction: float, M: int) -> int:
    return max(1, min(M, int(round(block_fraction * M))))


@register_block_selector("random")
def random_selector(ctx: SelectorContext) -> torch.Tensor:
    """Each worker samples ~frac*M blocks uniformly from its neighborhood."""
    return select_blocks(ctx.rng, ctx.edge, ctx.block_fraction)


@register_block_selector("cyclic")
def cyclic_selector(ctx: SelectorContext) -> torch.Tensor:
    """Gauss-Seidel sweep: every worker updates block (t mod M); workers
    whose edge set misses that block fall back to a random draw."""
    M = ctx.edge.shape[1]
    sel = torch.zeros_like(ctx.edge)
    sel[:, ctx.t % M] = True
    sel &= ctx.edge
    fallback = (~sel.any(dim=1, keepdim=True)
                & select_blocks(ctx.rng, ctx.edge, ctx.block_fraction))
    return sel | fallback


def make_zipf_selector(a: float = 1.1) -> BlockSelector:
    """Hot/cold block skew: each worker still picks ~frac*M blocks from
    its edge neighborhood, but block j is drawn with weight
    ``(j+1)^-a`` — weighted sampling without replacement via the
    Gumbel-top-k trick. ``a`` = 0 recovers the uniform selector."""
    if not np.isfinite(a) or a < 0.0:
        raise ValueError(f"zipf exponent must be finite and >= 0; got {a}")

    def zipf_selector(ctx: SelectorContext) -> torch.Tensor:
        N, M = ctx.edge.shape
        k = _top_k(ctx.block_fraction, M)
        logw = -a * torch.log(torch.arange(1, M + 1, dtype=torch.float32,
                                           device=ctx.edge.device))
        g = gumbel(ctx.rng, (N, M)) + logw[None, :]
        scored = torch.where(ctx.edge, g, -torch.inf)
        thresh = torch.topk(scored, k, dim=1).values[:, -1:]
        return (scored >= thresh) & ctx.edge

    # draws only from (seed, t): the PS runtime may run it timing-only
    zipf_selector.gradient_free = True
    return zipf_selector


register_block_selector("zipf")(make_zipf_selector())


@register_block_selector("gauss_southwell")
def gauss_southwell_selector(ctx: SelectorContext) -> torch.Tensor:
    """Greedy: exactly the top-k blocks by gradient norm within the edge
    set. Ties go to the lower block index, as the reference's
    ``lax.top_k`` breaks them: a stable descending sort keeps equal
    norms in index order (``torch.topk`` promises no order)."""
    M = ctx.edge.shape[1]
    gnorm = torch.where(ctx.edge, ctx.grad_sqnorm(), -torch.inf)
    k = _top_k(ctx.block_fraction, M)
    idx = torch.sort(gnorm, dim=1, descending=True, stable=True).indices
    sel = torch.zeros_like(ctx.edge).scatter_(1, idx[:, :k], True)
    return sel & ctx.edge


# ---------------------------------------------------------------------------
# the packed block mechanics and the two spaces
# ---------------------------------------------------------------------------

class _PackedOps:
    """Shared mechanics of the packed block representation: z is an
    (M, dblk) block table, worker bundles are (N, M, dblk) tensors — the
    kernels' native shape, so the ``cuda`` backend dispatches without
    reshapes. Subclasses supply the *packer* (the user-representation
    codec) and ``init_repr``."""

    @property
    def packer(self):
        return self.blocks

    @property
    def num_blocks(self) -> int:
        return self.packer.num_blocks

    def _use_kernels(self) -> bool:
        return self.backend == "cuda"

    def _launch(self, op: str, bundle):
        """(threads, blocks per SM) of this kernel dispatch from the
        autotuner's table ("cached" / "sweep" modes) for the bundle's
        (N, M, d) on its card; None -> the kernel's default launch (a
        miss, or autotune "off"). A host-side lookup: no device work."""
        if getattr(self, "autotune", "off") == "off":
            return None
        from ..kernels.autotune import device_kind, lookup_tile
        N, M, d = bundle.shape
        return lookup_tile(op, N, M, d, dev=device_kind(bundle.device))

    # ---- representation -------------------------------------------------
    def to_user(self, z):
        return self.packer.from_blocks(z)

    # ---- history --------------------------------------------------------
    def init_history(self, z0, depth):
        return z0.expand((depth,) + tuple(z0.shape)).clone()

    def current(self, z_hist):
        return z_hist[0]

    def push(self, z_hist, z_new):
        return push_history(z_hist, z_new)

    def gather(self, z_hist, delays):
        return gather_delayed(z_hist, delays)

    # ---- worker side ----------------------------------------------------
    def worker_grads(self, loss_fn, z_tilde, data, minibatch=None, rng=None):
        data = subsample_worker_data(rng, data, minibatch)
        with step_span("asybadmm.unpack"):
            z_user = self.packer.from_blocks(z_tilde)
        with step_span("asybadmm.loss"):
            g, losses = torch.func.vmap(torch.func.grad_and_value(loss_fn))(
                z_user, data)
        with step_span("asybadmm.pack"):
            return losses, self.packer.to_blocks(g)

    def grad_sqnorm(self, g):
        return torch.sum(torch.square(g), dim=-1)

    def worker_update(self, g, y, z_tilde, rho_vec):
        return worker_update(g, y, z_tilde, rho_vec[:, None, None])

    def select(self, sel, new, old):
        return torch.where(sel[..., None], new, old)

    def worker_select_update(self, g, y, z_tilde, w_cache, x, sel, rho_vec,
                             track_x):
        if self._use_kernels():
            out = kernel_ops.admm_worker_select_update(
                g, y, z_tilde, w_cache, sel, rho_vec,
                x if track_x else None,
                launch=self._launch("worker_select_update", g))
            return out if track_x else (out[0], out[1], x)
        x_new, y_new, w_new = self.worker_update(g, y, z_tilde, rho_vec)
        return (self.select(sel, y_new, y),
                self.select(sel, w_new, w_cache),
                self.select(sel, x_new, x) if track_x else x)

    # ---- server side ----------------------------------------------------
    def reduce_workers(self, w, edge):
        return torch.sum(torch.where(edge[..., None], w, 0.0), dim=0)

    def server_update(self, z_cur, w_sum, rho_sum, gamma, prox):
        return server_update(z_cur, w_sum, rho_sum[:, None], gamma, prox)

    def server_consensus_update(self, z_cur, w_cache, edge, rho_sum, gamma,
                                reg):
        if self._use_kernels() and reg.fusable:
            return kernel_ops.server_prox_update(
                z_cur, w_cache, edge, rho_sum, gamma, reg.l1_coef,
                0.0 if reg.clip is None else reg.clip,
                launch=self._launch("server_prox_fused", w_cache))
        w_sum = self.reduce_workers(w_cache, edge)
        return self.server_update(z_cur, w_sum, rho_sum, gamma, reg.prox)

    def server_prox(self, z_cur, w_sum, rho_sum, gamma, reg):
        """Prox step (13) from an already-reduced w_sum — the SPMD path,
        where the worker reduction is a partial sum + all-reduce over the
        data ranks and only the prox remains local to the block-server
        shard."""
        if self._use_kernels() and reg.fusable:
            return kernel_ops.prox_consensus(
                z_cur, w_sum, rho_sum, gamma, reg.l1_coef,
                0.0 if reg.clip is None else reg.clip)
        return self.server_update(z_cur, w_sum, rho_sum, gamma, reg.prox)

    # ---- state construction --------------------------------------------
    def zeros_workers(self, z0):
        return torch.zeros((self.num_workers,) + tuple(z0.shape),
                           dtype=z0.dtype, device=z0.device)

    def broadcast_workers(self, z0):
        return z0.expand((self.num_workers,) + tuple(z0.shape)).clone()

    def workers_scaled(self, z0, rho_vec):
        return rho_vec[:, None, None] * z0[None]

    def worker_leaves(self, bundle):
        return [bundle]


@dataclasses.dataclass(frozen=True)
class FlatSpace(_PackedOps):
    """Flat-vector consensus: z is (M, dblk) blocks of a padded vector
    (:class:`~repro_torch.core.blocks.FlatBlocks`); worker bundles are
    (N, M, dblk) tensors. All mechanics come from :class:`_PackedOps`.
    With ``mesh`` set, the epoch runs SPMD on local tiles (see
    ``core/sharded.py``)."""
    blocks: FlatBlocks
    num_workers: int
    backend: str = "torch"
    mesh: Any = None
    autotune: str = "off"                 # off | cached (after make_spec)

    def init_repr(self, z0, device):
        if z0 is None:
            return torch.zeros((self.blocks.num_blocks, self.blocks.block_dim),
                               dtype=torch.float32, device=device)
        return self.blocks.to_blocks(
            torch.as_tensor(z0, dtype=torch.float32, device=device))


@dataclasses.dataclass(frozen=True)
class TreeSpace(_PackedOps):
    """Pytree consensus, lowered onto the packed block layout: z is the
    same (M, dblk) table flat mode uses, block j's leaves packed into row
    j (:class:`~repro_torch.core.blocks.BlockLayout`, zero-padded,
    bitwise round-trip). Worker bundles are (N, M, dblk) tensors;
    arithmetic runs in float32 and leaves cast back to their stored
    dtype at ``to_user`` and for the loss. Everything past the gradient
    is :class:`_PackedOps`' and so ``FlatSpace``'s: the kernels, the
    SPMD sharding of rows over ``model``, the PS runtime's block ids."""
    blocks: TreeBlocks
    num_workers: int
    backend: str = "torch"
    mesh: Any = None
    layout: Any = None                    # BlockLayout (required to run)
    autotune: str = "off"                 # off | cached (after make_spec)

    @property
    def packer(self):
        if self.layout is None:
            raise ValueError(
                "TreeSpace needs its packed BlockLayout; build the space "
                "via ConsensusSession.pytree, or pass "
                "layout=make_block_layout(params, blocks)")
        return self.layout

    def init_repr(self, z0, device):
        if z0 is None:
            raise ValueError("TreeSpace needs an initial params pytree")
        return self.packer.to_blocks(
            tree_map(lambda a: torch.as_tensor(a, device=device), z0))

    def worker_grads(self, loss_fn, z_tilde, data, minibatch=None, rng=None):
        """As :meth:`_PackedOps.worker_grads`, differentiating the list of
        leaves (views of z~ for f32 leaves): ``torch.func`` takes a
        ``None`` node for a leaf, which the layout's trees keep as JAX
        does. The loss must not write its params in place (autograd
        refuses it under ``grad``)."""
        data = subsample_worker_data(rng, data, minibatch)
        layout = self.packer
        treedef = layout.tree.treedef

        def leaf_loss(leaves, d):
            return loss_fn(tree_unflatten(treedef, leaves), d)

        with step_span("asybadmm.unpack"):
            leaves = layout.unpack_leaves(z_tilde)
        with step_span("asybadmm.loss"):
            g, losses = torch.func.vmap(
                torch.func.grad_and_value(leaf_loss))(leaves, data)
        with step_span("asybadmm.pack"):
            return losses, layout.pack_leaves(g)


# ---------------------------------------------------------------------------
# the state / spec / epoch
# ---------------------------------------------------------------------------

class ConsensusState(NamedTuple):
    """State of Algorithm 1.

    z_hist : bounded-staleness ring buffer, leading axis depth (= D+1),
             index 0 newest;
    y      : per-(worker, block) duals (== -last gradient, appendix 25);
    w_cache: server-side stale w~ cache;
    x      : last primal iterates (kept only when the spec tracks them —
             the stationarity metric needs them; None otherwise);
    t      : epoch counter (a Python int: with the spec's seed it fixes
             the epoch's random draws).
    """
    z_hist: torch.Tensor
    y: torch.Tensor
    w_cache: torch.Tensor
    x: Optional[torch.Tensor]
    t: int

    @property
    def z_blocks(self):
        """Newest consensus blocks (M, dblk)."""
        return self.z_hist[0]


@dataclasses.dataclass(frozen=True)
class ConsensusSpec:
    """Everything one epoch of Algorithm 1 needs besides state + data."""
    space: Any                         # FlatSpace | TreeSpace
    loss_fn: Callable                  # loss_fn(z_user, worker_data) -> scalar
    edge: torch.Tensor                 # (N, M) bool — the paper's E
    rho_vec: torch.Tensor              # (N,) per-worker penalties rho_i
    reg: Regularizer
    gamma: float
    block_fraction: float
    selector: BlockSelector
    delay_model: DelayModel
    track_x: bool = False
    seed: int = 0
    # incremental/stochastic workers (Hong 2014): fraction of each
    # worker's samples drawn fresh per epoch (None/1.0 = full batch)
    minibatch: Optional[float] = None

    @property
    def device(self) -> torch.device:
        return self.rho_vec.device


# generator streams of one epoch
_DELAY, _SELECT, _BATCH = 0, 1, 2


def make_spec(space, cfg, loss_fn, *, edge=None, rho_scale=None, reg=None,
              selector=None, delay_model=None, track_x=False,
              backend=None, mesh=None, minibatch=None,
              autotune=None, device: DeviceLike = None) -> ConsensusSpec:
    """Build a ConsensusSpec from an ADMMConfig plus problem structure.

    ``backend`` (torch | cuda | auto) overrides ``cfg.backend`` and is
    resolved onto the space for ``device`` (None -> ``cuda``).

    ``mesh`` (a ``launch.mesh.Mesh``, or a preset name for
    ``launch.mesh.resolve_mesh``) overrides ``cfg.mesh`` and is resolved
    onto the space — when set, ``asybadmm_epoch`` runs the SPMD-sharded
    epoch (core/sharded.py) over it. A preset builds its mesh over the
    default process group, which must then be initialised.

    ``autotune`` (off | cached | sweep) overrides ``cfg.autotune`` and
    selects where B1's and B2's launches come from
    (``kernels/autotune.py``): "off" their defaults, "cached" the tuned
    table. "sweep" measures this spec's shapes here, once (on the
    ``cuda`` backend: the epoch's (N, M, dblk) and under a mesh the
    local shard's), keeps the winners, then dispatches like "cached"."""
    from ..kernels.autotune import resolve_autotune, sweep_for_space
    from ..launch.mesh import resolve_mesh           # no cycle: mesh.py is leaf
    dev = resolve_device(device)
    resolved_mesh = resolve_mesh(
        mesh if mesh is not None else getattr(cfg, "mesh", None))
    tune = resolve_autotune(autotune if autotune is not None
                            else getattr(cfg, "autotune", "off"))
    resolved = resolve_backend(
        backend if backend is not None else getattr(cfg, "backend", "auto"),
        dev)
    if space.backend != resolved:
        space = dataclasses.replace(space, backend=resolved)
    if resolved_mesh is not None:
        from .sharded import validate_space_mesh
        space = dataclasses.replace(space, mesh=resolved_mesh)
        validate_space_mesh(space)
    if tune == "sweep" and space._use_kernels():
        sweep_for_space(space.num_workers, space.num_blocks,
                        space.packer.block_dim, mesh=space.mesh, device=dev)
    # the sweep runs once, here; dispatch reads the kept winners
    tune = "cached" if tune == "sweep" else tune
    if space.autotune != tune:
        space = dataclasses.replace(space, autotune=tune)
    N, M = space.num_workers, space.num_blocks
    if edge is None:
        edge = torch.ones((N, M), dtype=torch.bool, device=dev)
    else:
        edge = torch.as_tensor(edge, device=dev).to(torch.bool)
    if rho_scale is None:
        rho_vec = torch.full((N,), float(cfg.rho), dtype=torch.float32,
                             device=dev)
    else:
        rho_vec = cfg.rho * torch.as_tensor(rho_scale, dtype=torch.float32,
                                            device=dev)
    if reg is None:
        reg = make_prox(cfg.l1_coef, cfg.clip)
    sel_arg = selector if selector is not None else cfg.block_selection
    if sel_arg == "zipf":
        sel = make_zipf_selector(getattr(cfg, "zipf_a", 1.1))
    else:
        sel = resolve_block_selector(sel_arg)
    if delay_model is None:
        delay_model = UniformDelay(cfg.max_delay)
    if minibatch is None:
        minibatch = getattr(cfg, "minibatch", None)
    if minibatch is not None:
        if not 0.0 < minibatch <= 1.0:
            raise ValueError(f"minibatch fraction must be in (0, 1]; "
                             f"got {minibatch}")
        if minibatch == 1.0:
            minibatch = None
    return ConsensusSpec(space=space, loss_fn=loss_fn, edge=edge,
                         rho_vec=rho_vec, reg=reg, gamma=cfg.gamma,
                         block_fraction=cfg.block_fraction, selector=sel,
                         delay_model=delay_model, track_x=track_x,
                         seed=cfg.seed, minibatch=minibatch)


def init_consensus_state(spec: ConsensusSpec, z0=None) -> ConsensusState:
    """Algorithm 1 lines 1-2. ``z0`` is in user representation (a flat
    vector, default 0; a params pytree). With a mesh on the space, the
    state is this rank's local tiles."""
    space = spec.space
    z0r = space.init_repr(z0, spec.device)
    rho_vec = spec.rho_vec
    if space.mesh is not None:
        from .sharded import local_space, local_tile
        tile = local_tile(spec)
        space = local_space(spec, tile.Nl)
        z0r, rho_vec = tile.cols(z0r, axis=0), tile.rows(rho_vec)
    return ConsensusState(
        z_hist=space.init_history(z0r, spec.delay_model.depth),
        y=space.zeros_workers(z0r),                       # Alg. 1 line 2
        # w init: w = rho_i * x + y with x = z0, y = 0  ->  rho_i * z0
        w_cache=space.workers_scaled(z0r, rho_vec),
        x=space.broadcast_workers(z0r) if spec.track_x else None,  # line 1
        t=0,
    )


def state_from_numpy(arrays: Mapping[str, Any], spec: ConsensusSpec,
                     device: DeviceLike = None) -> ConsensusState:
    """Continue a run started elsewhere (e.g. in the JAX reference): build
    the port's state from numpy leaves ``z_hist``, ``y``, ``w_cache``,
    ``x`` and ``t`` (extra keys such as the reference's ``rng`` are
    ignored; the port's draws follow from ``spec.seed`` and ``t``). The
    leaves are the full single-device arrays; with a mesh on the space,
    each rank keeps its local tiles of them."""
    dev = resolve_device(device)
    N, M = spec.edge.shape
    dblk = spec.space.packer.block_dim
    depth = spec.delay_model.depth
    from .sharded import Tile, local_tile
    tile = (Tile.whole(N, M) if spec.space.mesh is None
            else local_tile(spec))

    def tensor(name, shape, worker_bundle=True):
        a = np.array(arrays[name], np.float32)          # a private copy
        if a.shape != shape:
            raise ValueError(f"state_from_numpy: {name} has shape {a.shape}, "
                             f"the spec needs {shape}")
        a = tile.cols(torch.as_tensor(a))
        return (tile.rows(a) if worker_bundle else a).contiguous().to(dev)

    return ConsensusState(
        z_hist=tensor("z_hist", (depth, M, dblk), worker_bundle=False),
        y=tensor("y", (N, M, dblk)),
        w_cache=tensor("w_cache", (N, M, dblk)),
        x=tensor("x", (N, M, dblk)) if spec.track_x else None,
        t=int(np.asarray(arrays["t"])))


# Divergence watchdog (debug): when enabled, every epoch checks the
# freshly committed z table for NaN/Inf and halts with the offending
# round + block ids instead of silently training on garbage. Off by
# default — the check copies a flag to the host every epoch.
_EPOCH_CHECK_FINITE = False


def set_epoch_check_finite(enabled: bool) -> bool:
    """Toggle the epoch-level NaN/Inf watchdog; returns the previous
    setting (so tests/callers can restore it)."""
    global _EPOCH_CHECK_FINITE
    prev = _EPOCH_CHECK_FINITE
    _EPOCH_CHECK_FINITE = bool(enabled)
    return prev


def _check_finite(t: int, z_new: torch.Tensor) -> None:
    bad = ~torch.isfinite(z_new.reshape(z_new.shape[0], -1)).all(dim=1)
    if bool(bad.any()):
        blocks = torch.nonzero(bad).flatten().tolist()
        raise FloatingPointError(
            f"asybadmm_epoch divergence watchdog: the round-{t} z "
            f"update produced NaN/Inf in block(s) {blocks} — the run is "
            f"training on garbage. Check rho / gamma / step sizes; "
            f"disable with set_epoch_check_finite(False).")


def asybadmm_epoch(spec: ConsensusSpec, state: ConsensusState, data
                   ) -> Tuple[ConsensusState, Dict[str, torch.Tensor]]:
    """One epoch of Algorithm 1 across all workers + servers.

    With a mesh on the space, the same epoch runs SPMD: this rank's share
    of it (core/sharded.py), on its local tiles of the state."""
    with step_span("asybadmm.epoch"):
        if spec.space.mesh is not None:
            from .sharded import sharded_epoch
            return sharded_epoch(spec, state, data)
        return _epoch(spec, state, data)


def _epoch(spec: ConsensusSpec, state: ConsensusState, data
           ) -> Tuple[ConsensusState, Dict[str, torch.Tensor]]:
    space = spec.space
    N, M = spec.edge.shape
    dev = spec.device

    # --- each worker pulls (possibly stale) z~ per block (Assumption 3) ---
    with step_span("asybadmm.gather"):
        delays = sample_delay_model(
            spec.delay_model,
            seeded_generator(dev, spec.seed, state.t, _DELAY), N, M, state.t)
        z_tilde = space.gather(state.z_hist, delays)

    # --- local gradients at z~ (eq. 5 linearization point), optionally on
    #     a fresh per-worker minibatch (incremental workers, Hong 2014) ---
    r_batch = (seeded_generator(dev, spec.seed, state.t, _BATCH)
               if spec.minibatch is not None else None)
    losses, g = space.worker_grads(spec.loss_fn, z_tilde, data,
                                   minibatch=spec.minibatch, rng=r_batch)

    with step_span("asybadmm.select"):
        # --- block selection (Alg. 1 line 4) via the shared policy
        #     registry ---
        ctx = SelectorContext(
            rng=seeded_generator(dev, spec.seed, state.t, _SELECT),
            edge=spec.edge, t=state.t, block_fraction=spec.block_fraction,
            grad_sqnorm=lambda: space.grad_sqnorm(g))
        sel = spec.selector(ctx)

        # --- partial participation: absent workers contribute no edge
        #     updates this round ---
        pmask = participation_mask_for(spec.delay_model, state.t, dev)
        if pmask is not None:
            sel = sel & pmask
        info = {"loss": torch.mean(losses),
                "selected_fraction": torch.mean(sel.to(torch.float32))}

    # --- worker update (11)(12)(9) + the sel-masked merges, one fused
    #     pass over the worker bundles on the cuda backend ---
    y, w_cache, x = space.worker_select_update(
        g, state.y, z_tilde, state.w_cache, state.x, sel, spec.rho_vec,
        spec.track_x)

    # --- server update (13): fresh w for pushers, stale cache otherwise;
    #     the cuda backend fuses the edge-masked reduce into the prox ---
    rho_sum = torch.sum(torch.where(spec.edge, spec.rho_vec[:, None], 0.0),
                        dim=0)                                      # (M,)
    z_new = space.server_consensus_update(
        space.current(state.z_hist), w_cache, spec.edge, rho_sum,
        spec.gamma, spec.reg)

    if _EPOCH_CHECK_FINITE:
        _check_finite(state.t, z_new)

    with step_span("asybadmm.push"):
        z_hist = space.push(state.z_hist, z_new)
    return ConsensusState(z_hist=z_hist, y=y, w_cache=w_cache, x=x,
                          t=state.t + 1), info


def consensus_residual(spec: ConsensusSpec, state: ConsensusState
                       ) -> torch.Tensor:
    """Cross-worker dispersion of the w cache (0 at consensus); on a
    sharded state, completed over the mesh (the same on every rank)."""
    if spec.space.mesh is not None:
        from .sharded import consensus_residual as sharded_residual
        return sharded_residual(spec, state)
    num = torch.zeros((), dtype=torch.float32, device=spec.device)
    den = torch.zeros((), dtype=torch.float32, device=spec.device)
    for leaf in spec.space.worker_leaves(state.w_cache):
        w32 = leaf.to(torch.float32)
        mean = torch.mean(w32, dim=0, keepdim=True)
        num = num + torch.sum(torch.square(w32 - mean))
        den = den + torch.sum(torch.square(mean)) * leaf.shape[0]
    return torch.sqrt(num / torch.clamp_min(den, 1e-12))
