"""The measured window: steps enqueued back to back for ``seconds`` of
host time, one synchronise at its end, and a CUDA event recorded on the
stream after every step, read once the window has closed.

The host never waits inside the window, so the rate is the device's
unless the host falls behind it; the events give each step's own time,
gaps included, for a tail.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import torch


@dataclasses.dataclass
class Window:
    steps: int                  # steps completed in the window
    seconds: float              # host wall time, first enqueue to the sync
    start_wall: float           # time.time() at the window's start
    step_ms: Optional[List[float]]   # each step's time by CUDA events


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(step: Callable[[int], None], seconds: float, device) -> Window:
    """Call ``step(k)`` for k = 0, 1, ... until ``seconds`` of host time
    have passed, then wait for the device."""
    cuda = torch.device(device).type == "cuda"
    sync(device)
    start_wall = time.time()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    marks = []
    if cuda:
        first = torch.cuda.Event(enable_timing=True)
        first.record()
        marks.append(first)
    k = 0
    while True:
        step(k)
        k += 1
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        if time.perf_counter() >= deadline:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    step_ms = ([marks[i - 1].elapsed_time(marks[i])
                for i in range(1, len(marks))] if cuda else None)
    return Window(steps=k, seconds=elapsed, start_wall=start_wall,
                  step_ms=step_ms)


def p95(values: List[float]) -> float:
    """The 95th percentile by the nearest-rank rule."""
    ordered = sorted(values)
    rank = max(1, -(-95 * len(ordered) // 100))
    return ordered[rank - 1]
