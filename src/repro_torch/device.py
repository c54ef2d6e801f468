"""Device resolution and seeded generators shared by every entry point.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and with no CUDA device that is an
error, never a quiet move to the CPU.

JAX splits a PRNG key per epoch; torch has no such keys, so every draw
comes from a ``torch.Generator`` seeded from a tuple of integers (for
the epoch: the spec's seed, the epoch counter and a stream id). The
draws of epoch t are then a pure function of ``(seed, t)``, which keeps
the consensus state free of generator objects.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def seeded_generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integer tuple ``key``
    (mixed through numpy's SeedSequence, so neighbouring keys give
    unrelated streams)."""
    words = np.random.SeedSequence([int(k) for k in key]).generate_state(
        2, np.uint32)
    seed = (int(words[0]) << 31) ^ int(words[1])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
