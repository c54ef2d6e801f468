"""Synthetic KDDa-like sparse classification data (the paper's workload).

The real KDDa set (8.4M samples, 20M features, 305M nonzeros — paper §5)
is not available offline; this generator reproduces its *structure*:
extremely sparse rows, power-law feature popularity, and per-worker
locality so each worker's edge neighborhood N(i) covers only part of the
feature space — exactly what makes block-wise ADMM pay off.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SparseLogRegData:
    X: np.ndarray          # (N_workers, m_per, d) dense-with-zeros design
    y: np.ndarray          # (N_workers, m_per) labels in {-1, +1}
    support: np.ndarray    # (N_workers, d) bool — worker feature support
    w_true: np.ndarray     # (d,) generating weights (sparse)


def make_sparse_logreg(num_workers: int, samples_per_worker: int, dim: int,
                       *, density: float = 0.1, weight_density: float = 0.2,
                       locality: float = 0.5, noise: float = 0.1,
                       seed: int = 0) -> SparseLogRegData:
    """locality in [0,1): fraction of each worker's features drawn from a
    worker-private band (creates the sparse edge set E); the rest come
    from a shared power-law pool."""
    rng = np.random.RandomState(seed)
    N, m, d = num_workers, samples_per_worker, dim

    # power-law popularity over the shared pool
    pop = 1.0 / (np.arange(d) + 1.0)
    pop /= pop.sum()

    band = d // N
    X = np.zeros((N, m, d), np.float32)
    nnz_per_row = max(1, int(density * d))
    for i in range(N):
        lo, hi = i * band, (i + 1) * band
        for r in range(m):
            k_local = int(locality * nnz_per_row)
            k_shared = nnz_per_row - k_local
            cols_local = rng.randint(lo, hi, size=k_local)
            cols_shared = rng.choice(d, size=k_shared, p=pop)
            cols = np.concatenate([cols_local, cols_shared])
            X[i, r, cols] = rng.randn(len(cols)).astype(np.float32)

    w_true = np.where(rng.rand(d) < weight_density, rng.randn(d), 0.0)
    logits = np.einsum("nmd,d->nm", X, w_true) + noise * rng.randn(N, m)
    y = np.where(rng.rand(N, m) < 1.0 / (1.0 + np.exp(-logits)), 1.0, -1.0)
    support = (np.abs(X).sum(axis=1) > 0)
    return SparseLogRegData(X=X, y=y.astype(np.float32), support=support,
                            w_true=w_true.astype(np.float32))
