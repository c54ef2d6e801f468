"""Block partitioning for general form consensus (paper §2.2).

Two user-facing representations, one packed ``(M, dblk)`` table
underneath, element for element the reference's (``repro/core/blocks.py``)
so states and block ids carry across:

* **flat mode**: the decision variable is a flat vector of dim ``d``
  padded and reshaped to a lane-aligned ``(M, dblk)`` table; block j is
  row j. The edge set E is an (N, M) bool matrix: worker i touches block
  j iff its local data has support there.
* **pytree mode**: every leaf of a params tree is assigned to one of M
  blocks, balanced by size (greedy LPT, :class:`TreeBlocks`), and
  :class:`BlockLayout` packs block j's leaves into row j of the same
  table (zero padding, bitwise round-trip).

**Block-id contract**: block j of a :class:`BlockLayout` is row j of the
table, in ``TreeBlocks.leaf_block_ids`` order, with the leaves listed as
``jax.tree.flatten`` lists them (``core/tree.py``). Selection masks and
edge sets index columns j, the SPMD ``model`` axis shards rows j, and
the PS runtime's lock domains group ids j, so a block id means the same
server in every execution mode and in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from .tree import TreeDef, tree_flatten, tree_unflatten

#: Packed block rows are rounded up to a multiple of this at layout-build
#: time. The reference chose it for the TPU's 128-wide vector lanes; the
#: port keeps it so its tables match the reference's, and its kernels
#: rely on it: every row then starts on a 512-byte boundary, so 16-byte
#: vector accesses never straddle two rows.
LANE = 128


def round_up_to_lane(n: int, lane: int = LANE) -> int:
    """Smallest multiple of ``lane`` >= max(n, 1)."""
    return -(-max(int(n), 1) // lane) * lane


@dataclasses.dataclass(frozen=True)
class FlatBlocks:
    """Flat-vector block partition onto the lane-aligned ``(M, dblk)`` table.

    The coordinate partition is governed by ``used_dim`` (block j owns
    coordinates ``[j*used_dim, (j+1)*used_dim)`` of the original vector);
    ``block_dim`` is ``used_dim`` rounded up to the 128-lane boundary, so
    rows carry ``block_dim - used_dim`` trailing pad lanes (plus the usual
    tail-of-vector pad inside the last block's used region, and whole
    rows past ``dim`` where ``M * used_dim`` overshoots it). Pad lanes
    are zero on pack, never read on unpack, and inert through every
    epoch op.

    The codec moves each element once: :meth:`to_blocks` writes a fresh
    table (never a view of its input) with one copy of the whole blocks
    and one of the ragged block, and zeroes only the pad lanes;
    :meth:`from_blocks` returns a contiguous vector, filled by the same
    two copies the other way, or a reshape of the table where the layout
    pads nothing. Either is element for element the reference's.
    """
    dim: int          # original vector dim
    num_blocks: int   # M
    block_dim: int    # lane-aligned per-block row width (dblk)
    used_dim: int = 0 # coordinates per block before lane padding (0 -> block_dim)

    def __post_init__(self):
        if self.used_dim == 0:
            object.__setattr__(self, "used_dim", self.block_dim)
        if not 0 < self.used_dim <= self.block_dim:
            raise ValueError(
                f"used_dim={self.used_dim} must be in (0, block_dim="
                f"{self.block_dim}]")

    @property
    def padded_dim(self) -> int:
        """Table capacity M * dblk (includes lane padding)."""
        return self.num_blocks * self.block_dim

    @property
    def logical_dim(self) -> int:
        """Coordinate capacity M * used_dim (before lane padding)."""
        return self.num_blocks * self.used_dim

    def padding_mask(self) -> np.ndarray:
        """(M, dblk) bool — True on real coordinates, False on padding."""
        mask = np.zeros((self.num_blocks, self.block_dim), bool)
        for j in range(self.num_blocks):
            used = min(self.used_dim, max(0, self.dim - j * self.used_dim))
            mask[j, :used] = True
        return mask

    def to_blocks(self, v):
        """(..., d) -> a fresh (..., M, block_dim) table, pad lanes zero.

        One read of ``v`` and one write of the table: the whole blocks
        land in one copy, the ragged block's coordinates in a second,
        and zeros go only where no coordinate lands (each row's lane
        pads, the ragged block's tail, blocks wholly past ``dim``)."""
        if v.shape[-1] != self.dim:
            raise ValueError(f"vector of dim {v.shape[-1]}; the layout "
                             f"holds {self.dim}")
        used = self.used_dim
        full, rem = divmod(self.dim, used)
        out = v.new_empty(tuple(v.shape[:-1])
                          + (self.num_blocks, self.block_dim))
        out[..., :full, :used].copy_(
            v[..., :full * used].unflatten(-1, (full, used)))
        out[..., :full, used:].zero_()
        if rem:
            out[..., full, :rem].copy_(v[..., full * used:])
            out[..., full, rem:].zero_()
        out[..., full + (rem > 0):, :].zero_()
        return out

    def from_blocks(self, b):
        """(..., M, block_dim) -> (..., d); pad lanes are never read.

        Where the layout pads nothing (``used_dim == block_dim`` and
        ``dim == M * block_dim``) a reshape of ``b``, a view when ``b`` is
        contiguous; otherwise a fresh contiguous vector filled by
        :meth:`to_blocks`' two copies the other way."""
        if tuple(b.shape[-2:]) != (self.num_blocks, self.block_dim):
            raise ValueError(
                f"table rows {tuple(b.shape[-2:])}; the layout's are "
                f"{(self.num_blocks, self.block_dim)}")
        lead = tuple(b.shape[:-2])
        if self.used_dim == self.block_dim and self.dim == self.padded_dim:
            return b.reshape(lead + (self.dim,))
        used = self.used_dim
        full, rem = divmod(self.dim, used)
        out = b.new_empty(lead + (self.dim,))
        out[..., :full * used].unflatten(-1, (full, used)).copy_(
            b[..., :full, :used])
        if rem:
            out[..., full * used:].copy_(b[..., full, :rem])
        return out


def make_flat_blocks(dim: int, num_blocks: int) -> FlatBlocks:
    used_dim = -(-dim // num_blocks)
    return FlatBlocks(dim=dim, num_blocks=num_blocks,
                      block_dim=round_up_to_lane(used_dim), used_dim=used_dim)


def edge_set_from_support(support: np.ndarray, blocks: FlatBlocks) -> np.ndarray:
    """support: (N, d) bool — which coordinates each worker's data touches.
    Returns E: (N, M) bool (worker i, block j) — the paper's edge set.
    Lane padding carries no support, so it is computed over ``used_dim``."""
    N, d = support.shape
    pad = blocks.logical_dim - d
    sp = np.pad(support, [(0, 0), (0, pad)])
    return sp.reshape(N, blocks.num_blocks, blocks.used_dim).any(axis=-1)


# --------------------------------------------------------------------------
# pytree mode
# --------------------------------------------------------------------------

def _dtype_name(dtype) -> str:
    """``float32``, ``bfloat16``, ... for a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name


def _size(shape) -> int:
    return int(np.prod(tuple(shape), dtype=np.int64))


@dataclasses.dataclass(frozen=True)
class TreeBlocks:
    """Per-leaf block ids for a params pytree (greedy size-balanced)."""
    num_blocks: int
    leaf_block_ids: Tuple[int, ...]      # aligned with tree_leaves order
    treedef: TreeDef

    def block_id_tree(self):
        return tree_unflatten(self.treedef, list(self.leaf_block_ids))

    def mask_tree(self, selected):
        """selected: (M,) 0/1 tensor -> pytree of scalar multipliers."""
        return tree_unflatten(self.treedef,
                              [selected[i] for i in self.leaf_block_ids])

    def block_sizes(self, tree) -> np.ndarray:
        sizes = np.zeros(self.num_blocks, np.int64)
        for leaf, bid in zip(tree_flatten(tree)[0], self.leaf_block_ids):
            sizes[bid] += _size(leaf.shape)
        return sizes


def make_tree_blocks(tree, num_blocks: int) -> TreeBlocks:
    """LPT: leaves largest first, each to the least-loaded block. The
    order is the reference's ``np.argsort(sizes)[::-1]`` over the same
    list, so ties between equal leaves fall as they fall there (a stable
    sort would give another table)."""
    leaves, treedef = tree_flatten(tree)
    sizes = [_size(leaf.shape) for leaf in leaves]
    order = np.argsort(sizes)[::-1]                     # LPT: largest first
    load = np.zeros(num_blocks, np.int64)
    ids = [0] * len(leaves)
    for li in order:
        j = int(np.argmin(load))
        ids[int(li)] = j
        load[j] += sizes[int(li)]
    return TreeBlocks(num_blocks=num_blocks, leaf_block_ids=tuple(ids),
                      treedef=treedef)


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Packed block layout: a params pytree lowered onto the flat-mode
    ``(M, dblk)`` block table.

    Block j's leaves are raveled and placed (in leaf order) into row j;
    rows are zero-padded to ``block_dim`` = the largest packed block
    rounded up to :data:`LANE`. ``to_blocks`` / ``from_blocks`` mirror
    :class:`FlatBlocks` (leading batch axes, worker N or ring depth D+1,
    pass through) and round-trip bitwise: arithmetic happens in
    ``dtype`` (float32), and f32, bf16 and f16 leaves embed in it
    exactly. Pad lanes are zero on pack, never read on unpack, and inert
    through every epoch op (all lane-local).
    """
    tree: TreeBlocks
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_dtypes: Tuple[str, ...]          # dtype names (hashable/comparable)
    leaf_offsets: Tuple[int, ...]         # per leaf: offset within its row
    block_leaves: Tuple[Tuple[int, ...], ...]  # per block: leaf idx, pack order
    block_sizes: Tuple[int, ...]          # per block: packed (pad-free) size
    block_dim: int                        # dblk (max packed block size)
    dtype: str = "float32"                # packed compute dtype

    @property
    def num_blocks(self) -> int:
        return self.tree.num_blocks

    @property
    def block_ids(self) -> Tuple[int, ...]:
        """Per-leaf block assignment — THE block-id contract."""
        return self.tree.leaf_block_ids

    def padding_mask(self) -> np.ndarray:
        """(M, dblk) bool — True on real coordinates, False on padding."""
        mask = np.zeros((self.num_blocks, self.block_dim), bool)
        for j, used in enumerate(self.block_sizes):
            mask[j, :used] = True
        return mask

    def window_leaf_ids(self, window=None) -> Tuple[int, ...]:
        """The leaves of the block window ``(m0, Ml)``, blocks [m0, m0 +
        Ml), in leaf order; every leaf when ``window`` is None. A leaf
        lies in one block, so a window holds whole leaves."""
        if window is None:
            return tuple(range(len(self.leaf_shapes)))
        m0, Ml = window
        return tuple(k for k, b in enumerate(self.block_ids)
                     if m0 <= b < m0 + Ml)

    def window_rows(self, window=None) -> int:
        """Ml, the rows of the window's table (M when ``window`` is
        None)."""
        return self.num_blocks if window is None else window[1]

    def _lead(self, leaves, ids) -> Tuple[int, ...]:
        if len(leaves) != len(ids):
            raise ValueError(f"{len(leaves)} leaves; the layout's window "
                             f"holds {len(ids)}")
        lead = leaves[0].ndim - len(self.leaf_shapes[ids[0]])
        batch = tuple(leaves[0].shape[:lead])
        for leaf, k in zip(leaves, ids):
            if tuple(leaf.shape) != batch + self.leaf_shapes[k]:
                raise ValueError(
                    f"leaf {k} has shape {tuple(leaf.shape)}; expected "
                    f"batch {batch} + {self.leaf_shapes[k]} (layout built "
                    f"for a different tree?)")
        return batch

    def leaf_starts(self, window=None) -> Tuple[int, ...]:
        """Per leaf of the window: start offset within the row-major
        flattened table of its rows."""
        m0 = 0 if window is None else window[0]
        return tuple((self.block_ids[k] - m0) * self.block_dim
                     + self.leaf_offsets[k]
                     for k in self.window_leaf_ids(window))

    def pack_leaves(self, leaves, window=None):
        """Leaves (in ``tree_flatten`` order, shapes ``batch +
        leaf_shape``) -> the table ``batch + (M, dblk)``: one zeroed
        table, each leaf cast into its window by one copy (no
        concatenated intermediate). Under a block ``window`` (m0, Ml)
        the leaves are the window's and the table its Ml rows."""
        ids = self.window_leaf_ids(window)
        batch = self._lead(leaves, ids)
        rows = self.window_rows(window)
        out = torch.zeros(batch + (rows, self.block_dim),
                          dtype=getattr(torch, self.dtype),
                          device=leaves[0].device)
        flat = out.view(batch + (rows * self.block_dim,))
        for leaf, k, start in zip(leaves, ids, self.leaf_starts(window)):
            size = _size(self.leaf_shapes[k])
            flat.narrow(-1, start, size).copy_(
                leaf.reshape(batch + (size,)))
        return out

    def unpack_leaves(self, arr, window=None):
        """The table ``batch + (M, dblk)`` (a ``window``'s ``batch +
        (Ml, dblk)``) -> its leaves in ``tree_flatten`` order, in their
        stored dtypes; padding dropped. Leaves in the compute dtype are
        views of the (contiguous) table: each reads only its own
        window."""
        batch = tuple(arr.shape[:-2])
        flat = arr.contiguous().view(
            batch + (self.window_rows(window) * self.block_dim,))
        leaves = []
        for k, start in zip(self.window_leaf_ids(window),
                            self.leaf_starts(window)):
            piece = flat.narrow(-1, start, _size(self.leaf_shapes[k]))
            leaves.append(piece.view(batch + self.leaf_shapes[k])
                          .to(getattr(torch, self.leaf_dtypes[k])))
        return leaves

    def to_blocks(self, tree_val, window=None):
        """Pack a pytree (leaves ``batch + leaf_shape``) into the block
        table ``batch + (M, dblk)`` in the packed compute dtype. Under a
        ``window`` the tree is :meth:`from_blocks`'s: the window's
        leaves, every other leaf ``None``."""
        leaves, treedef = tree_flatten(tree_val)
        if window is None and treedef != self.tree.treedef:
            raise ValueError(f"tree structure {treedef} does not match the "
                             f"layout's {self.tree.treedef}")
        return self.pack_leaves(leaves, window)

    def from_blocks(self, arr, window=None):
        """Unpack a block table ``batch + (M, dblk)`` back to the pytree
        (leaves cast back to their stored dtypes; padding dropped). Under
        a ``window`` the leaves outside it are ``None``."""
        leaves = [None] * len(self.leaf_shapes)
        for k, leaf in zip(self.window_leaf_ids(window),
                           self.unpack_leaves(arr, window)):
            leaves[k] = leaf
        return tree_unflatten(self.tree.treedef, leaves)


def make_block_layout(tree, blocks: TreeBlocks = None, *,
                      num_blocks: int = None, dtype="float32") -> BlockLayout:
    """Build the packed layout for ``tree`` (tensors, on any device
    including ``meta``; only shapes and dtypes are read). ``blocks``
    defaults to the LPT assignment of :func:`make_tree_blocks` over
    ``num_blocks``."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot build a BlockLayout for an empty pytree")
    if blocks is None:
        blocks = make_tree_blocks(tree, num_blocks)
    if treedef != blocks.treedef:
        raise ValueError(f"tree structure {treedef} does not match the "
                         f"TreeBlocks' {blocks.treedef}")
    sizes = [_size(leaf.shape) for leaf in leaves]
    block_leaves = tuple(
        tuple(k for k, b in enumerate(blocks.leaf_block_ids) if b == j)
        for j in range(blocks.num_blocks))
    offsets = [0] * len(leaves)
    block_sizes = []
    for kidx in block_leaves:
        off = 0
        for k in kidx:
            offsets[k] = off
            off += sizes[k]
        block_sizes.append(off)
    return BlockLayout(
        tree=blocks,
        leaf_shapes=tuple(tuple(leaf.shape) for leaf in leaves),
        leaf_dtypes=tuple(_dtype_name(leaf.dtype) for leaf in leaves),
        leaf_offsets=tuple(offsets),
        block_leaves=block_leaves,
        block_sizes=tuple(block_sizes),
        block_dim=round_up_to_lane(max(1, max(block_sizes))),
        dtype=_dtype_name(dtype))
