"""The cell's inputs, made on the device from ``--seed``: the data of
the flat solve, a model's weights and the token batches. Every draw
comes from a generator seeded from (seed, stream), so the same seed
gives the same inputs, and the reference is handed the same ones by
drawing them again.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

STREAMS = {"centers": 1, "weights": 2, "tokens": 3}


def generator(device, seed: int, stream: str) -> torch.Generator:
    """A generator on ``device`` for one of the benchmark's streams."""
    words = np.random.SeedSequence(
        [int(seed) % (1 << 64), STREAMS[stream]]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return gen


def centers(seed: int, workers: int, dim: int, device) -> torch.Tensor:
    """(N, dim) float32 worker data c_i ~ N(0, 1), one call."""
    return torch.randn((workers, dim), generator=generator(
        device, seed, "centers"), device=device)


# A leaf's init: ("dense", fan_in) -> N(0, 1/fan_in); ("embed",) ->
# N(0, 0.02^2); ("ones",) -> 1.
Init = Tuple[Any, ...]


def weights(shapes: Dict[Tuple[str, ...], Tuple[Tuple[int, ...], Init]],
            seed: int, device) -> Dict[str, Any]:
    """The nested dict of float32 leaves for ``shapes`` (path -> (shape,
    init)), drawn by one ``randn`` over every element and scaled leaf by
    leaf in place; the leaves are views of that one buffer."""
    total = sum(math.prod(shape) for shape, _ in shapes.values())
    buf = torch.randn((total,), generator=generator(device, seed, "weights"),
                      device=device)
    tree: Dict[str, Any] = {}
    offset = 0
    for path in sorted(shapes):
        shape, init = shapes[path]
        n = math.prod(shape)
        leaf = buf[offset:offset + n].view(shape)
        offset += n
        if init[0] == "dense":
            leaf.mul_(1.0 / math.sqrt(init[1]))
        elif init[0] == "embed":
            leaf.mul_(0.02)
        elif init[0] == "ones":
            leaf.fill_(1.0)
        else:
            raise ValueError(f"{'.'.join(path)}: unknown init {init!r}")
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree
