"""Bounded-delay asynchrony simulation (Assumption 3).

True asynchrony does not exist inside one device program; what the
theory needs is only *bounded staleness*: z~_j^t = z_j^{t-tau},
tau <= T_ij. We reproduce exactly that semantics deterministically:

* a ring buffer keeps the last D+1 versions of every z block
  (index 0 = newest);
* each worker draws a per-(i, j) delay tau_ij ~ U{0..D} per step and
  reads z~_ij = z_hist[tau_ij, j];
* the server mixes fresh w pushes with its stale w~ cache (eq. 13).

Every draw takes an explicit ``torch.Generator`` and lands on the
generator's device.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def push_history(z_hist, z_new):
    """z_hist: (D+1, M, dblk); insert z_new at index 0, shifting back."""
    if z_hist.shape[0] == 1:
        return z_new[None]
    return torch.cat([z_new[None], z_hist[:-1]], dim=0)


def sample_delays(gen: torch.Generator, n_workers: int, n_blocks: int,
                  max_delay: int):
    """Per-(i,j) integer delays in [0, max_delay]."""
    if max_delay == 0:
        return torch.zeros((n_workers, n_blocks), dtype=torch.int64,
                           device=gen.device)
    return torch.randint(0, max_delay + 1, (n_workers, n_blocks),
                         generator=gen, device=gen.device)


def gather_delayed(z_hist, delays):
    """z_hist: (D+1, M, dblk); delays: (N, M) -> z~: (N, M, dblk)."""
    cols = torch.arange(z_hist.shape[1], device=z_hist.device)
    return z_hist[delays, cols[None, :]]


def gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log U) with U kept off 0."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def minibatch_rows(gen: torch.Generator, n_workers: int, n_samples: int,
                   fraction: float):
    """Per-worker without-replacement subsample indices (N, k) with
    k = max(1, round(fraction * n_samples)) — a uniform random-subset
    draw realized as an argsort of i.i.d. uniforms."""
    k = max(1, min(n_samples, int(round(fraction * n_samples))))
    u = torch.rand((n_workers, n_samples), generator=gen, device=gen.device)
    return torch.argsort(u, dim=1)[:, :k]


def validate_minibatch_data(data):
    """Check every data leaf is (num_workers, samples, ...) with one
    shared sample axis; returns (num_workers, num_samples)."""
    leaves = pytree.tree_leaves(data)
    if not leaves:
        return None
    n_samples = leaves[0].shape[1] if leaves[0].ndim >= 2 else None
    for leaf in leaves:
        if leaf.ndim < 2 or leaf.shape[1] != n_samples:
            raise ValueError(
                f"minibatch subsampling needs every data leaf shaped "
                f"(num_workers, samples, ...); got {tuple(leaf.shape)} vs "
                f"samples={n_samples}")
    return leaves[0].shape[0], n_samples


def subsample_worker_data(gen, data, fraction):
    """Incremental/stochastic worker gradients (Hong 2014): subsample a
    ``fraction`` of every worker's samples along axis 1 of each data
    leaf, using the SAME per-worker row indices across leaves (X and y
    stay aligned). ``fraction`` of None / >= 1 is a no-op."""
    if fraction is None or fraction >= 1.0:
        return data
    shape = validate_minibatch_data(data)
    if shape is None:
        return data
    n_workers, n_samples = shape
    idx = minibatch_rows(gen, n_workers, n_samples, fraction)
    rows = torch.arange(n_workers, device=idx.device)[:, None]
    return pytree.tree_map(lambda a: a[rows, idx], data)


def select_blocks(gen, edge, block_fraction: float):
    """Per-worker random block selection (Alg. 1 line 4).

    edge: (N, M) bool.  block_fraction == 1 selects every block in N(i)
    (the synchronous full-sweep limit); otherwise each worker samples
    ~max(1, frac*|N(i)|) blocks uniformly from its neighborhood without
    replacement (Gumbel top-k over the edge support).
    """
    N, M = edge.shape
    if block_fraction >= 1.0:
        return edge
    k = max(1, int(round(block_fraction * M)))
    scored = torch.where(edge, gumbel(gen, (N, M)), -torch.inf)
    thresh = torch.topk(scored, k, dim=1).values[:, -1:]
    return (scored >= thresh) & edge
