"""Plain reference of the flat solve: Algorithm 1 of AsyBADMM
(arXiv:1802.08882) on the (M, dblk) block table, epoch after epoch,
from the inputs the harness hands it (the worker data c_i, the edge set
and the settings) and the draws of ``draws.py``.

The worker loss is f_i(z) = 0.5 ||z - c_i||^2, whose gradient is
z - c_i. One epoch:

* z~_ij = z_{t - tau_ij, j} from the ring of the last D + 1 versions;
* for each selected (i, j): g = z~ - c_ij, x = z~ - (g + y) / rho,
  y' = -g, w = rho x + y' (eqs. 11, 12, 9); other pairs keep y, w, x;
* each block: v = (gamma z_j + sum over edge workers in order of w_ij)
  / (gamma + sum of their rho), then the prox of l1 and the box (eq. 13,
  22): soft threshold at l1 / mu, clip at C;
* the new z enters the ring at the front.

The vector of ``dim`` coordinates is cut into M blocks of ceil(dim / M)
coordinates, each row rounded up to 128 lanes with zeros; pad lanes stay
zero through every step. ``dtype`` is the precision of the whole
computation: float32 as the configuration states, bfloat16 for the
control.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import draws

LANE = 128


def table_shape(dim: int, blocks: int) -> Tuple[int, int]:
    """(used, dblk): coordinates per block and the lane-rounded row."""
    used = -(-dim // blocks)
    return used, -(-used // LANE) * LANE


def to_table(v: torch.Tensor, blocks: int) -> torch.Tensor:
    """(..., dim) -> (..., M, dblk), zero padded."""
    dim = v.shape[-1]
    used, dblk = table_shape(dim, blocks)
    rows = F.pad(v, (0, blocks * used - dim)).reshape(
        v.shape[:-1] + (blocks, used))
    return F.pad(rows, (0, dblk - used))


def replay(centers: torch.Tensor, edge: torch.Tensor, s: Dict,
           seed: int, epochs: int, dtype=torch.float32
           ) -> Dict[str, torch.Tensor]:
    """The state after ``epochs`` epochs from z = 0: z_hist (D + 1, M,
    dblk) newest first, y, w_cache, x (N, M, dblk)."""
    N, M = edge.shape
    dev = centers.device
    c = to_table(centers.to(dtype), M)
    dblk = c.shape[-1]
    D = int(s["max_delay"])
    rho = torch.tensor(float(s["rho"]), dtype=dtype, device=dev)
    gamma = float(s["gamma"])
    l1, clip = float(s["l1_coef"]), s["clip"]
    z_hist = torch.zeros((D + 1, M, dblk), dtype=dtype, device=dev)
    y = torch.zeros((N, M, dblk), dtype=dtype, device=dev)
    w = torch.zeros_like(y)                 # rho * z0 with z0 = 0
    x = torch.zeros_like(y)
    edge_rows = edge.to(dev)
    full = edge_rows.all(dim=1).tolist()
    mu = (gamma + float(s["rho"]) * edge_rows.sum(0).to(dtype))[:, None]
    thresh = l1 / mu
    for t in range(epochs):
        tau = draws.delays(dev, seed, t, N, M, D)
        sel = draws.selection(dev, seed, t, edge_rows,
                              float(s["block_fraction"]))
        i, j = sel.nonzero(as_tuple=True)
        zt = z_hist[tau[i, j], j]
        g = zt - c[i, j]
        step = (g + y[i, j]).div_(rho)
        xn = zt.sub_(step)                  # z~ - (g + y) / rho
        yn = g.neg_()
        wn = torch.mul(xn, rho).add_(yn)
        y[i, j], w[i, j], x[i, j] = yn, wn, xn
        total = torch.where(edge_rows[0][:, None], w[0], 0.0)
        for n in range(1, N):               # in worker order, as stated
            total.add_(w[n] if full[n] else
                       torch.where(edge_rows[n][:, None], w[n], 0.0))
        v = (gamma * z_hist[0] + total) / mu
        if l1 > 0.0:
            v = torch.sign(v) * torch.clamp_min(torch.abs(v) - thresh, 0.0)
        if clip is not None:
            v = torch.clamp(v, -float(clip), float(clip))
        z_hist = torch.cat([v[None], z_hist[:-1]]) if D else v[None]
    return {"z_hist": z_hist, "y": y, "w_cache": w, "x": x}
