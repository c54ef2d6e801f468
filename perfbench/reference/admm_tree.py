"""Plain reference of ADMM training over a parameter tree: Algorithm 1
of AsyBADMM with each leaf in one of M blocks, for the first steps of a
run, from the weights and batches the harness hands it.

Blocks: the leaves, in sorted path order, largest first (numpy's
``argsort`` of their sizes, reversed), each to the least-loaded block
(LPT). One step t, for every worker i:

* z~_i: each leaf from the ring version its block's delay tau_ij
  names (``draws.py``);
* (loss_i, g_i) = the loss and its gradient at z~_i on batch i;
* selected (i, j): x = z~ - (g + y) / rho, y' = -g, w = rho x + y';

then every block: z = prox((gamma z + sum over edge workers of w_ij) /
(gamma + sum of their rho)) (identity without l1 or a box), pushed onto
the ring. The step's loss is the mean of the workers' losses.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import draws


def lpt_blocks(sizes: Sequence[int], blocks: int) -> List[int]:
    """Block id of each leaf (sizes in sorted path order)."""
    order = np.argsort(list(sizes))[::-1]
    load = np.zeros(blocks, np.int64)
    ids = [0] * len(sizes)
    for li in order:
        j = int(np.argmin(load))
        ids[int(li)] = j
        load[j] += sizes[int(li)]
    return ids


def block_sizes(sizes: Sequence[int], blocks: int) -> List[int]:
    out = [0] * blocks
    for size, j in zip(sizes, lpt_blocks(sizes, blocks)):
        out[j] += size
    return out


LossGrad = Callable[[int, int, Dict[Tuple[str, ...], torch.Tensor]],
                    Tuple[torch.Tensor, Dict[Tuple[str, ...], torch.Tensor]]]


def run(z0: Dict[Tuple[str, ...], torch.Tensor], loss_grad: LossGrad,
        s: Dict, seed: int, steps: int, workers: int, edge: torch.Tensor):
    """``steps`` steps from z0 (path -> leaf). ``loss_grad(t, i, z)``
    gives worker i's loss and gradient (path -> leaf) at z on step t's
    batch. Returns the step losses, the first step's gradient norms
    [worker][path] and z after the last step (path -> leaf)."""
    paths = sorted(z0)
    M = edge.shape[1]
    bid = dict(zip(paths, lpt_blocks([z0[p].numel() for p in paths], M)))
    dev = z0[paths[0]].device
    D = int(s["max_delay"])
    # every divisor a tensor on the device: a division by a host number
    # is a multiplication by its reciprocal there, not the IEEE quotient
    rho = torch.tensor(float(s["rho"]), device=dev)
    gamma = torch.tensor(float(s["gamma"]), device=dev)
    l1, clip = float(s.get("l1_coef") or 0.0), s.get("clip")
    edge = edge.to(dev)
    mu = gamma + rho * edge.sum(0).to(torch.float32)          # (M,)
    ring = [dict(z0) for _ in range(D + 1)]
    y = {p: torch.zeros((workers,) + z0[p].shape, device=dev) for p in paths}
    w = {p: rho * z0[p].expand((workers,) + z0[p].shape).clone()
         for p in paths}
    losses, first_norms = [], None
    for t in range(steps):
        tau = draws.delays(dev, seed, t, workers, M, D).tolist()
        sel = draws.selection(dev, seed, t, edge,
                              float(s["block_fraction"])).tolist()
        step_losses, norms = [], []
        for i in range(workers):
            zt = {p: ring[tau[i][bid[p]]][p] for p in paths}
            value, g = loss_grad(t, i, zt)
            step_losses.append(float(value))
            norms.append({p: float(torch.linalg.vector_norm(g[p]))
                          for p in paths})
            for p in paths:
                if sel[i][bid[p]]:
                    x = zt[p] - (g[p] + y[p][i]) / rho
                    y[p][i] = -g[p]
                    w[p][i] = rho * x + y[p][i]
            del g, zt
        if first_norms is None:
            first_norms = norms
        z_new = {}
        for p in paths:
            j = bid[p]
            total = torch.zeros_like(z0[p])
            for i in range(workers):
                if edge[i, j]:
                    total = total + w[p][i]
            v = (gamma * ring[0][p] + total) / mu[j]
            if l1 > 0.0:
                thresh = l1 / mu[j]
                v = torch.sign(v) * torch.clamp_min(torch.abs(v) - thresh, 0)
            if clip is not None:
                v = torch.clamp(v, -float(clip), float(clip))
            z_new[p] = v
        ring = [z_new] + ring[:-1]
        losses.append(math.fsum(step_losses) / workers)
    return losses, first_norms, ring[0]
