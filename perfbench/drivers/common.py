"""What both drivers share: the precision the configuration states,
the peak read, and the steps' loss tally."""
from __future__ import annotations

import gc
from typing import List

import torch


def set_precision(config) -> None:
    """TF32 on or off for float32 products, as the configuration says."""
    tf32 = bool(config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device):
    return (int(torch.cuda.max_memory_allocated())
            if device.type == "cuda" else None)


def allocator_counts(device) -> dict:
    """The caching allocator's calls to the driver and its retries (a
    retry frees the cache, a synchronising cudaFree, and allocates
    again): the run's memory pressure."""
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats()
    return {key: stats.get(key) for key in (
        "num_alloc_retries", "num_device_alloc", "num_device_free",
        "reserved_bytes.all.peak")}


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def non_finite(losses: List[torch.Tensor]) -> int:
    """How many of the steps' reported losses are not finite."""
    if not losses:
        return 0
    values = torch.stack([v.detach().float().reshape(()) for v in losses])
    return int((~torch.isfinite(values)).sum())

