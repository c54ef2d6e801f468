"""Block partitioning for general form consensus (paper §2.2), flat mode.

The decision variable is a flat vector of dim ``d`` padded and reshaped
to a lane-aligned ``(M, dblk)`` table; block j is row j. The edge set E
is an (N, M) bool matrix: worker i touches block j iff its local data
has support there. The table is element for element the reference's
(``repro/core/blocks.py``), so states and block ids carry across.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch.nn.functional as F

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
    tail-of-vector pad inside the last block's used region). Pad lanes are
    zero on pack, never read on unpack, and inert through every epoch op.
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
        """(..., d) -> (..., M, block_dim)."""
        vp = F.pad(v, (0, self.logical_dim - self.dim))
        rows = vp.reshape(tuple(v.shape[:-1])
                          + (self.num_blocks, self.used_dim))
        if self.used_dim == self.block_dim:
            return rows
        return F.pad(rows, (0, self.block_dim - self.used_dim))

    def from_blocks(self, b):
        """(..., M, block_dim) -> (..., d). Pad lanes are never read."""
        rows = b[..., : self.used_dim]
        flat = rows.reshape(tuple(b.shape[:-2]) + (self.logical_dim,))
        return flat[..., : self.dim]


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
