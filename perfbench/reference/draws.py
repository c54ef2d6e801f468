"""The random draws of one ADMM epoch, worked out again: the delays of
Assumption 3 and the random block selection of Algorithm 1 line 4, as
the system under test states them.

Epoch t draws from generators on the state's device seeded from (seed,
t, stream), stream 0 the delays and 1 the selection, each seed mixed
through numpy's SeedSequence into a 63-bit word. The delays are
uniform on 0..D per (worker, block); the selection keeps, for each
worker, its k = max(1, round(fraction * M)) edge blocks of largest
Gumbel score (every edge block when fraction >= 1).
"""
from __future__ import annotations

import numpy as np
import torch

DELAY, SELECT = 0, 1


def generator(device, *key: int) -> torch.Generator:
    words = np.random.SeedSequence([int(k) for k in key]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return gen


def delays(device, seed: int, t: int, workers: int, blocks: int,
           max_delay: int) -> torch.Tensor:
    """(N, M) int64 delays in 0..max_delay."""
    if max_delay == 0:
        return torch.zeros((workers, blocks), dtype=torch.int64,
                           device=device)
    gen = generator(device, seed, t, DELAY)
    return torch.randint(0, max_delay + 1, (workers, blocks), generator=gen,
                         device=device)


def selection(device, seed: int, t: int, edge: torch.Tensor,
              fraction: float) -> torch.Tensor:
    """(N, M) bool: the blocks each worker updates at epoch t."""
    if fraction >= 1.0:
        return edge
    workers, blocks = edge.shape
    k = max(1, int(round(fraction * blocks)))
    gen = generator(device, seed, t, SELECT)
    u = torch.rand((workers, blocks), generator=gen, device=device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    scored = torch.where(edge, -torch.log(-torch.log(u)), -torch.inf)
    thresh = torch.topk(scored, k, dim=1).values[:, -1:]
    return (scored >= thresh) & edge
