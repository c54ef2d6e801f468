"""Bytes and FLOPs of one rank's share of an SPMD epoch of the flat
solve, by ``flat.py``'s rules, for the rooflines of the rank that is
traced.

The rank holds the rows of its workers (``rows``) and the whole (M,
dblk) ring. B1 runs on its (rows, M, dblk) tile; the step's least bytes
and FLOPs are ``flat.epoch``'s for those rows alone: their z~, c, y and
stale w, the writes of their selected pairs, and the whole server step's
write of z. The all-reduce's traffic between cards is not counted.

B3 (the prox from the reduced w sum) reads z and w_sum and writes z on
the whole (M, dblk) table: 3 M rows.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from . import flat


def epoch(edge_rows: List[List[bool]], fraction: float, dblk: int,
          track_x: bool, rows: Sequence[int]) -> Dict[str, float]:
    M = len(edge_rows[0])
    counts = flat.epoch([edge_rows[i] for i in rows], fraction, dblk,
                        track_x)
    del counts["b2_bytes"]                  # the SPMD epoch never runs B2
    counts["b3_bytes"] = 3 * M * dblk * flat.ELEM
    return counts
