"""The traced window split by the program's step spans.

The port records a named range (``repro_torch/obs/names.py::
STEP_SPANS``) at each boundary of its step while a profiler records, so
the spans lie in the trace beside the kernels, on their clock. Each
device operation in the window (kernel, copy, set) is charged to the
innermost step span open when its launch was made: the launching CUDA
runtime call is found by ``args.correlation``, and the span by that
call's start, on any host thread (under ``torch.func.grad`` the autograd
engine launches the backward's kernels from its own thread while the
caller waits inside ``asybadmm.loss``). Within ``asybadmm.loss`` a launch
made inside an ``autograd::engine::evaluate_function`` op, on any
thread, is backward, every other forward. B1, B2 and ``rho_sum`` fall to
``asybadmm.epoch`` itself.

The traced host time a step is the wall time of the outermost step
spans less the time in runtime calls that waited on the device: a
synchronise, or a launch or copy longer than ``WAIT_US`` (a launch that
found the device's queue full). It is the host under the profiler, which
records every ATen op: an upper bound on the host's own dispatch, and
most of it the profiler's cost.

The readers get the window's ``Summary`` only. ``for_summary`` finds the
trace it was reduced from among those under ``perfbench/out/traces/``,
newest first, by its window's length, and reads it once per summary. A
trace with no step span (a program that records none) gives None.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

from . import manifest
from .trace import DEVICE_CATS, WINDOW_RANGE, Summary, _union

# the program's step spans (the yardstick's copy of STEP_SPANS' names)
TRAIN_STEP = "admm.train_step"
EPOCH = "asybadmm.epoch"
GATHER = "asybadmm.gather"
UNPACK = "asybadmm.unpack"
LOSS = "asybadmm.loss"
PACK = "asybadmm.pack"
SELECT = "asybadmm.select"
PUSH = "asybadmm.push"
STEP_SPANS = (TRAIN_STEP, EPOCH, GATHER, UNPACK, LOSS, PACK, SELECT, PUSH)
FORWARD, BACKWARD = LOSS + ":forward", LOSS + ":backward"
NO_SPAN = "no step span"

# the program records its spans through _RecordFunctionFast: cpu_op
SPAN_CAT = "cpu_op"
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD_OP = "autograd::engine::evaluate_function"
LAUNCHES = ("cudaLaunch", "cuLaunch")
COPIES = ("cudaMemcpy", "cudaMemset")
# A launch or copy longer than this waited for room in the device's
# queue: the trough between the two modes of the launch calls' times in
# a traced flat cell, 4-16 us of dispatch and 128-1024 us of waiting
# (PERF.md §6)
WAIT_US = 50.0


@dataclasses.dataclass
class Split:
    steps: int
    device_s: Dict[str, float]    # part -> device seconds in the window
    spans: Dict[str, int]         # step span -> times opened in the window
    traced_host_s: float          # outermost spans' time less the waits
    malloc_calls: int             # cudaMalloc inside admm.train_step

    def device_ms(self, *parts: str) -> Optional[float]:
        """Device ms a step under ``parts``; None when none of their
        spans was opened."""
        if not any(self.spans.get(p.split(":")[0]) for p in parts):
            return None
        return 1e3 * sum(self.device_s.get(p, 0.0) for p in parts) \
            / self.steps

    @property
    def traced_host_ms(self) -> float:
        return 1e3 * self.traced_host_s / self.steps


def _innermost(spans, times) -> List[Optional[str]]:
    """For each of ``times``, the name of the latest-opened span of
    ``spans`` ((start, end, name), nested) open then, else None."""
    order = sorted(range(len(times)), key=times.__getitem__)
    out: List[Optional[str]] = [None] * len(times)
    stack: list = []
    j = 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def _inside(intervals, t: float) -> bool:
    """Whether ``t`` lies in the union ``intervals`` (sorted, disjoint)."""
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][1] >= t


def _overlap(intervals, a: float, b: float) -> float:
    """The length of [a, b] that ``intervals`` (sorted, disjoint)
    cover."""
    i = max(bisect.bisect_right(intervals, (a, float("inf"))) - 1, 0)
    total = 0.0
    while i < len(intervals) and intervals[i][0] < b:
        x, y = intervals[i]
        total += max(0.0, min(b, y) - max(a, x))
        i += 1
    return total


def window(events):
    """(start, end) of the harness's window range, or None."""
    return next(((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("ph") == "X" and e.get("name") == WINDOW_RANGE
                 and e.get("cat") == "user_annotation"), None)


def split(path: Path, steps: int) -> Optional[Split]:
    """The window of the trace at ``path`` split by step spans; None
    without a window or a step span in it."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return split_events(events, steps)


def split_events(events, steps: int) -> Optional[Split]:
    bounds = window(events)
    if bounds is None or steps <= 0:
        return None
    w0, w1 = bounds
    spans, ops, calls = [], [], {}
    backward = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        a, b = e["ts"], e["ts"] + e.get("dur", 0)
        if cat == SPAN_CAT and name in STEP_SPANS:
            if a >= w0 and b <= w1:
                spans.append((a, b, name))
        elif cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                ops.append((b - a, (e.get("args") or {}).get("correlation")))
        elif cat in RUNTIME_CATS:
            corr = (e.get("args") or {}).get("correlation")
            calls[corr if corr is not None else id(e)] = (
                a, b, e.get("tid"), name)
        elif cat == "cpu_op" and name.startswith(BACKWARD_OP):
            backward.append((a, b))
    if not spans:
        return None
    spans.sort(key=lambda s: (s[0], -s[1]))
    backward = _union(backward)

    launched = [calls.get(corr) for _, corr in ops]
    owner = _innermost(spans, [c[0] if c else w0 - 1.0 for c in launched])
    device_s: Dict[str, float] = defaultdict(float)
    for (sec, _), call, name in zip(ops, launched, owner):
        if call is None or name is None:
            name = NO_SPAN
        elif name == LOSS:
            name = BACKWARD if _inside(backward, call[0]) else FORWARD
        device_s[name] += sec * 1e-6

    in_window = [c for c in calls.values() if w0 <= c[0] <= w1]
    waits = _union([(a, b) for a, b, _, name in in_window
                    if "Synchronize" in name
                    or (name.startswith(LAUNCHES + COPIES)
                        and b - a > WAIT_US)])
    outer, end = [], float("-inf")
    for a, b, _ in spans:
        if a > end:
            outer.append((a, b))
            end = b
    host_us = sum((b - a) - _overlap(waits, a, b) for a, b in outer)
    trains = [(a, b, n) for a, b, n in spans if n == TRAIN_STEP]
    mallocs = [c[0] for c in in_window if c[3] == "cudaMalloc"]
    malloc_calls = sum(n is not None for n in _innermost(trains, mallocs))
    opened: Dict[str, int] = defaultdict(int)
    for *_, name in spans:
        opened[name] += 1
    return Split(steps=steps, device_s=dict(device_s), spans=dict(opened),
                 traced_host_s=host_us * 1e-6, malloc_calls=malloc_calls)


def for_summary(summary: Summary) -> Optional[Split]:
    """The split of the trace ``summary`` was reduced from, read once
    per summary: the newest trace under ``out/traces/`` whose window has
    the summary's length. Raises when no trace there has it."""
    cached = getattr(summary, "_step_split", False)
    if cached is not False:
        return cached
    paths = sorted((manifest.OUT_DIR / "traces").glob("*.json"),
                   key=lambda p: -p.stat().st_mtime)
    for path in paths:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        bounds = window(events)
        if bounds is not None and \
                (bounds[1] - bounds[0]) * 1e-6 == summary.window_s:
            summary._step_split = split_events(events, summary.steps)
            return summary._step_split
        del events
    raise RuntimeError(
        f"no trace under {manifest.OUT_DIR / 'traces'} has the summarized "
        f"window ({summary.window_s} s)")
