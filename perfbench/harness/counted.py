"""A window of a fixed number of steps, for a cell whose ranks step
together: every rank of an SPMD group has to make the same number of
epochs (a rank that stopped on its own clock would leave the others
waiting in a collective), so the count is set before the window opens,
and the window times it. Otherwise as ``window.run``: the steps enqueued
back to back, one synchronise at the end, and a CUDA event recorded on
the stream after every step, read once the window has closed.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from .window import Window, sync


def run(step: Callable[[int], None], count: int, device) -> Window:
    """Call ``step(k)`` for k = 0 .. count - 1, then wait for the
    device."""
    cuda = torch.device(device).type == "cuda"
    sync(device)
    start_wall = time.time()
    t0 = time.perf_counter()
    marks = []
    if cuda:
        first = torch.cuda.Event(enable_timing=True)
        first.record()
        marks.append(first)
    for k in range(count):
        step(k)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
    sync(device)
    elapsed = time.perf_counter() - t0
    step_ms = ([marks[i - 1].elapsed_time(marks[i])
                for i in range(1, len(marks))] if cuda else None)
    return Window(steps=count, seconds=elapsed, start_wall=start_wall,
                  step_ms=step_ms)
