"""Count what a program of the port runs: FLOPs, HBM bytes, collective
bytes by kind and ops by name — the counterpart of the reference's
``analysis/hlo_cost.py`` and ``analysis/hlo.py``.

The reference costs lowered HLO. The port has no HLO, so it counts what
runs: under :func:`counting` every aten op that reaches the dispatcher
is charged, and in eager torch every such op is a kernel boundary. The
cost model is the reference's (``hlo_cost.py:1-17``), read for eager
torch:

  flops      : a matmul (``mm``, ``bmm``, ``addmm``, ...) 2 * prod(result)
               * prod(contracting); any other op 1 per result element;
  hbm bytes  : operand bytes + result bytes of each op; views, reshapes
               that need no copy, ``empty`` and metadata are free;
  collective : result bytes by kind (``all-reduce``, ``all-gather``,
               ``all-to-all``), charged where ``core/sharded.py``'s
               ``MeshCollectives`` (or ``SimCollectives``) runs one, and
               its operand + result bytes as HBM bytes.

The hand-written kernels (B1-B7) are launched through ``ctypes``, where
no dispatch mode sees them. ``kernels/ops.py`` reports each dispatch to
``analysis.hooks``, and the counter charges the kernel its declared cost
(:data:`KERNEL_COSTS`, from its operands' shapes and dtypes) and counts
nothing that runs inside: on the CPU or the meta device the plain
version runs there, on the card the kernel, and both cost the same.

Peak memory (``Cost.peak_bytes``, the counterpart of the reference's
``memory_analysis()``: its argument, output and temp sizes) is the most
bytes of storage alive at once while the program runs: the storages of
its arguments, and of every tensor an op makes, each storage counted
once (a view or an in-place op adds nothing) from the op that makes it
until it is freed (a weakref finalizer on the storage, not on the
tensor that wraps it). A kernel's charge counts its outputs alone: the
plain version that stands in for it off the card may make temporaries,
the card's kernels make none.

A program runs on the meta device where it can: a meta tensor has a
shape and no data, so a full-width train step or ``main``'s epoch at
``kdda_like`` is costed without the card's memory
(``device.seeded_generator`` gives meta draws); ``backend="cuda"`` on
meta is the program the card runs (B1, B2 or B3 dispatched through
``kernels/ops.py``). What
cannot run on meta: a path that reads a value on the host (``.item()``,
``float(t)``, ``int(t)``: the MoE ``scatter`` dispatch's capacity, the
PS runtime's schedule); cost those on the CPU at their own size.

    PYTHONPATH=src python -m repro_torch.analysis.report
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _flat

from . import hooks

aten = torch.ops.aten

# matmuls: the index of the operand whose last dim is contracted
_DOTS = {aten.mm: 0, aten.bmm: 0, aten.addmm: 1, aten.baddbmm: 1,
         aten.addbmm: 1, aten.mv: 0, aten.addmv: 1, aten.dot: 0,
         aten.vdot: 0}
# ops that move no data: allocation without a fill, a reshape that needs
# no copy, constants and metadata
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._unsafe_view, aten.detach,
         aten.lift_fresh, aten.lift_fresh_copy, aten.scalar_tensor,
         aten.sym_size, aten.sym_stride, aten.sym_numel,
         aten.sym_storage_offset, aten.is_same_size,
         aten._local_scalar_dense, aten.set_}


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def arg_tensors(tree) -> list:
    """The tensors of a program's arguments: the leaves of ``tree`` that
    are tensors, and the parameters and buffers of a module among them
    (the serving ``ParamTree``), each tensor once."""
    out, seen = [], set()
    for leaf in _flat(tree):
        if isinstance(leaf, torch.nn.Module):
            found = list(leaf.parameters()) + list(leaf.buffers())
        elif isinstance(leaf, torch.Tensor):
            found = [leaf]
        else:
            continue
        for t in found:
            if id(t) not in seen:
                seen.add(id(t))
                out.append(t)
    return out


def _is_view(func) -> bool:
    """An op whose result aliases an operand without writing it (view,
    reshape that needs no copy, transpose, ...)."""
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


@dataclasses.dataclass
class Cost:
    """A program's count. ``ops`` by name: aten ops by their packet name,
    kernels by their op name in ``kernels/ops.py``, collectives by kind."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    ops: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    kernel_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    peak_bytes: int = 0            # most storage bytes alive at once

    def charge(self, name: str, flops: float, hbm_bytes: float) -> None:
        self.flops += flops
        self.hbm_bytes += hbm_bytes
        self.ops[name] += 1

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())

    def same(self, other: "Cost") -> bool:
        """Equal counts: FLOPs, bytes, collectives and ops."""
        return (self.flops == other.flops
                and self.hbm_bytes == other.hbm_bytes
                and dict(self.collective_bytes) == dict(other.collective_bytes)
                and dict(self.ops) == dict(other.ops))

    def row(self) -> dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "peak_bytes": self.peak_bytes,
                "collective_bytes": dict(self.collective_bytes),
                "collective_bytes_total": self.collective_total,
                "kernel_bytes": dict(self.kernel_bytes),
                "ops": dict(self.ops)}


# ---------------------------------------------------------------------------
# the kernels' declared costs: (bytes, flops) from their operands
# ---------------------------------------------------------------------------

def _worker_select_update(g, y, z_tilde, w_old, sel, rho_vec, x_old):
    """B1: ``autotune.op_bytes`` (y, g, z~ read, or w and x in their
    stead on a row not selected; y', w' [, x'] written; sel and rho);
    5 flops an element of the update."""
    from ..kernels.autotune import op_bytes
    N, M, d = g.shape
    return (op_bytes("worker_select_update", N, M, d,
                     with_x=x_old is not None), 5 * N * M * d)


def _server_prox_update(z_cur, w_cache, edge, rho_sum):
    """B2: ``autotune.op_bytes`` (w_cache and z read, z' written, edge
    and rho_sum); a sum term a worker row and 8 flops of the prox an
    element."""
    from ..kernels.autotune import op_bytes
    N, M, d = w_cache.shape
    return (op_bytes("server_prox_fused", N, M, d), (N * M + 8 * M) * d)


def _prox_consensus(z_tilde, w_sum, rho_sum):
    """B3: z~ and w_sum read, z' written, rho_sum; 8 flops an element."""
    M, d = z_tilde.shape
    return 3 * _bytes(z_tilde) + _bytes(rho_sum), 8 * M * d


def _admm_worker_update(g, y, z_tilde):
    """B4: g, y, z~ read, x, y', w written, rho; 5 flops an element."""
    return 6 * _bytes(g) + 4, 5 * g.numel()


def _matmul(a, b, transpose_a):
    """B5: A, B read and C written once; 2 M N K."""
    K, N = b.shape
    M = a.shape[1] if transpose_a else a.shape[0]
    return a.element_size() * (a.numel() + b.numel() + M * N), 2 * M * N * K


def _margin(s, y):
    """B6: s, y read, v written; 5 flops an element."""
    return 3 * _bytes(s), 5 * s.numel()


def attention_pairs(S: int, T: int, causal: bool) -> int:
    """The (query, key) pairs attention needs: all S T, or under causal
    the keys at or before each query's index."""
    if not causal:
        return S * T
    n = min(S, T)
    return n * (n + 1) // 2 + (S - n) * T


def _flash_attention(q, k, v, causal):
    """B7: q, k, v read and the output written once; a multiply-add (2
    flops) per needed pair and channel in each of q k^T and p v."""
    BH, S, hd = q.shape
    return ((2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
            4 * BH * attention_pairs(S, k.shape[1], causal) * hd)


KERNEL_COSTS: Dict[str, Callable[..., Tuple[int, int]]] = {
    "admm_worker_select_update": _worker_select_update,     # B1
    "server_prox_update": _server_prox_update,              # B2
    "prox_consensus": _prox_consensus,                      # B3
    "admm_worker_update": _admm_worker_update,              # B4
    "matmul": _matmul,                                      # B5
    "margin": _margin,                                      # B6
    "flash_attention": _flash_attention,                    # B7
}


def kernel_cost(name: str, operands: tuple) -> Tuple[int, int]:
    """(bytes, flops) declared for one dispatch of kernel ``name``."""
    return KERNEL_COSTS[name](*operands)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

class _Live:
    """The storages alive now, each counted once, and the most bytes they
    ever held together. A storage leaves when it is freed."""

    def __init__(self, cost: Cost):
        self.cost = cost
        self.bytes = 0
        self.ids = set()

    def add(self, tensors) -> None:
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.ids:
                continue
            n = st.nbytes()
            self.ids.add(key)
            self.bytes += n
            weakref.finalize(st, self._free, key, n)
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.bytes)

    def _free(self, key, n) -> None:
        if key in self.ids:
            self.ids.discard(key)
            self.bytes -= n

    def close(self) -> None:
        """Stop counting: storages freed from here on are no longer
        this program's."""
        self.ids.clear()


class _Counter(TorchDispatchMode):
    """Charges each aten op it sees, and (through ``analysis.hooks``)
    each kernel and collective its declared cost, into ``cost``; tracks
    the storages alive for ``cost.peak_bytes``."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost
        self.paused = 0
        self.live = _Live(cost)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            self._charge_op(func, args, kwargs or {}, out)
            self.live.add(_flat(out))
        return out

    def _charge_op(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        if packet in _FREE or _is_view(func):
            return
        ins = [a for a in _flat((args, kwargs)) if isinstance(a, torch.Tensor)]
        outs = [o for o in _flat(out) if isinstance(o, torch.Tensor)]
        nbytes = sum(_bytes(t) for t in ins) + sum(_bytes(t) for t in outs)
        result = sum(t.numel() for t in outs)
        if packet in _DOTS:
            contract = ins[_DOTS[packet]].shape[-1] if ins[
                _DOTS[packet]].dim() else 1
            flops = 2 * result * contract
        else:
            flops = result
        self.cost.charge(packet.__name__, flops, nbytes)

    @contextlib.contextmanager
    def _uncounted(self):
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1

    def kernel(self, name: str, operands: tuple, run):
        if self.paused:
            return run()
        nbytes, flops = kernel_cost(name, operands)
        self.cost.charge(name, flops, nbytes)
        self.cost.kernel_bytes[name] += nbytes
        with self._uncounted():
            out = run()
        self.live.add(_flat(out))
        return out

    def collective(self, kind: str, x, run):
        if self.paused:
            return run()
        with self._uncounted():
            out = run()
        nout = _bytes(out)
        self.cost.charge(kind, 0, _bytes(x) + nout)
        self.cost.collective_bytes[kind] += nout
        self.live.add((out,))
        return out


@contextlib.contextmanager
def counting(*live):
    """Inside the block, every op, kernel and collective is charged into
    the :class:`Cost` it yields; ``live`` (tensors or trees of them: a
    program's arguments) are alive from the start, for its peak."""
    cost = Cost()
    counter = _Counter(cost)
    counter.live.add(arg_tensors(live))
    outer = hooks.counter
    hooks.counter = counter
    try:
        with counter:
            yield cost
    finally:
        hooks.counter = outer
        counter.live.close()


def count(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, its :class:`Cost`); the arguments count
    toward its peak."""
    with counting(args, kwargs) as cost:
        out = fn(*args, **kwargs)
    return out, cost
