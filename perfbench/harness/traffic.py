"""The one generator of traffic: it reads a workload file's ``params``
and makes the edge set of a flat solve or the token batches of a
training cell. A new mix is a new workload file of parameters.

Flat solve ``params``: ``edges`` ({"kind": "all"}, or {"kind": "band",
"width": w, "stride": s}: worker i holds blocks s*i .. s*i + w - 1 mod
M), ``block_fraction``, ``warmup_steps``, and optionally ``admm``
(overrides of the configuration's ADMM settings).

Training ``params``: ``sequences_per_worker``, ``seq_len``,
``distinct_batches`` (made in set-up and cycled), ``checked_steps``,
and optionally ``admm``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from .inputs import generator


def edges(spec: Dict[str, Any], workers: int, blocks: int,
          device) -> torch.Tensor:
    """(N, M) bool: the paper's edge set E."""
    kind = spec["kind"]
    if kind == "all":
        return torch.ones((workers, blocks), dtype=torch.bool, device=device)
    if kind == "band":
        width, stride = int(spec["width"]), int(spec["stride"])
        if not 0 < width <= blocks:
            raise ValueError(f"band width {width} outside 1..{blocks}")
        e = torch.zeros((workers, blocks), dtype=torch.bool)
        for i in range(workers):
            for k in range(width):
                e[i, (stride * i + k) % blocks] = True
        if not bool(e.any(dim=0).all()):
            raise ValueError("band edges leave a block with no worker")
        return e.to(device)
    raise ValueError(f"unknown edge kind {kind!r}")


def token_batches(params: Dict[str, Any], vocab: int, workers: int,
                  seed: int, device) -> torch.Tensor:
    """(K, N, B, S + 1) int64 token ids, uniform over the vocabulary: K
    distinct batches of B sequences of S + 1 tokens for each of N
    workers (step t takes batch t mod K: tokens are ids [:-1], labels
    [1:])."""
    shape = (int(params["distinct_batches"]), workers,
             int(params["sequences_per_worker"]), int(params["seq_len"]) + 1)
    return torch.randint(0, vocab, shape, generator=generator(
        device, seed, "tokens"), device=device)


def batch(batches: torch.Tensor, t: int) -> Dict[str, torch.Tensor]:
    """Step t's batch {"tokens", "labels"}: (N, B, S) each."""
    ids = batches[t % batches.shape[0]]
    return {"tokens": ids[..., :-1], "labels": ids[..., 1:]}
