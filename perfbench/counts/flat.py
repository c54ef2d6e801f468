"""Bytes of one epoch of the flat solve on the (M, dblk) block table,
float32 (4 bytes an element), for the rooflines.

B1 (the worker update with its sel-masked merges) returns new (N, M,
dblk) y, w and x tables, so its call must read y everywhere, g and z~
on selected rows, w and x on the others, and write the three outputs: 6
rows of every (worker, block) pair, whatever is selected; without x, 5
on a selected pair (read g, z~, y; write y, w) and 4 on another (copy y
and w).

B2 (the edge-masked reduce over workers and the prox) reads z and the
edge rows of the w cache and writes z: (edge pairs + 2 M) rows.

The epoch's least bytes, which bound its time from below: each input
read once and each output written once, only what the inputs need.
z~ needs at least one version of every block with an edge (M_e rows;
a second version that a delay names is not counted, so this is a lower
bound); the gradient of 0.5 ||z - c_i||^2 needs c on the selected
pairs; the update needs y there; the server's sum needs the stale w of
the edge pairs not selected (the fresh w of the selected ones is
computed on the way); y, w (and x) are written on the selected pairs
and z once. The loss the epoch also reports is a diagnostic and not
counted.
"""
from __future__ import annotations

from typing import Dict, List

ELEM = 4


def selected_per_worker(edge_rows: List[List[bool]],
                        fraction: float) -> List[int]:
    """How many blocks each worker updates: its k = max(1, round(fraction
    * M)) largest-scored edge blocks, so min(k, its edges); every edge
    block when fraction >= 1."""
    M = len(edge_rows[0])
    k = M if fraction >= 1.0 else max(1, int(round(fraction * M)))
    return [min(k, sum(row)) for row in edge_rows]


def epoch(edge_rows: List[List[bool]], fraction: float, dblk: int,
          track_x: bool) -> Dict[str, float]:
    N, M = len(edge_rows), len(edge_rows[0])
    pairs = N * M
    edges = sum(sum(row) for row in edge_rows)
    sel = sum(selected_per_worker(edge_rows, fraction))
    blocks_with_edges = sum(any(row[j] for row in edge_rows)
                            for j in range(M))
    row = dblk * ELEM
    if track_x:
        b1_rows = 6 * pairs
    else:
        b1_rows = 5 * sel + 4 * (pairs - sel)
    writes = (3 if track_x else 2) * sel
    least_rows = (blocks_with_edges + sel + sel + (edges - sel)
                  + writes + M)
    return {"b1_bytes": b1_rows * row,
            "b2_bytes": (edges + 2 * M) * row,
            "step_bytes": least_rows * row,
            "step_flops": 10 * sel * dblk,
            "selected_pairs": sel, "edge_pairs": edges}
