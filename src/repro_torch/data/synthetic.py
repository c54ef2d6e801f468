"""Deterministic synthetic token pipeline.

Generates a learnable bigram language (fixed random transition table) so
training losses genuinely decrease; batches are derived from (seed, step)
so the pipeline is stateless, shardable, and resumable.

The transition table is numpy and equals the reference's
(``repro/data/synthetic.py``) bit for bit. The reference draws each
batch with JAX's threefry, which torch cannot reproduce, so batches here
come from a torch generator seeded from (seed, step): same shapes, same
language, other tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, seeded_generator


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    branch: int = 4        # bigram branching factor (lower = more learnable)

    def table(self) -> np.ndarray:
        rng = np.random.RandomState(self.seed)
        return rng.randint(0, self.vocab_size,
                           size=(self.vocab_size, self.branch))

    def batch(self, step: int, *, num_workers: int = 1,
              enc_frames_dim: Optional[int] = None,
              enc_seq_len: int = 0,
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """Returns {"tokens", "labels"} of shape (B, S) — or with a
        leading worker axis (N, B/N, S) when num_workers > 1."""
        dev = resolve_device(device)
        table = torch.as_tensor(self.table(), device=dev)
        gen = seeded_generator(dev, self.seed, step)
        B, S = self.global_batch, self.seq_len
        tok = torch.randint(0, self.vocab_size, (B,), generator=gen,
                            device=dev)
        choices = torch.randint(0, self.branch, (B, S), generator=gen,
                                device=dev)
        seq = []
        for s in range(S):
            tok = table[tok, choices[:, s]]
            seq.append(tok)
        toks = torch.stack(seq, dim=1)                    # (B, S)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if enc_frames_dim is not None:
            batch["enc_frames"] = torch.randn(
                (B, enc_seq_len, enc_frames_dim), generator=gen,
                device=dev) * 0.1
        if num_workers > 1:
            if B % num_workers:
                raise ValueError(f"global_batch={B} is not divisible by "
                                 f"num_workers={num_workers}")
            batch = {k: v.reshape((num_workers, B // num_workers)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
        return batch
