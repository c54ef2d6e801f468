"""The traced run: ``torch.profiler`` around the window (CPU and CUDA
activity), its Chrome trace written under ``perfbench/out/traces/`` and
reduced to a ``Summary`` that the per-layer readers read.

Device operations are the trace's kernels, copies and sets; the window
is the ``perfbench.window`` range the harness records around the timed
loop (its end follows the loop's synchronise, so every step's device
work lies inside it). Busy time is the union of the device operations'
intervals in the window; an idle gap is named by the innermost host
operation that was running at its midpoint.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_RANGE = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")
GAPS_NAMED = 500            # the longest gaps named one by one
SCAN_LIMIT = 20000          # host ops looked at for one gap's name
NAME_CHARS = 120


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    steps: int
    kernels: Dict[str, Tuple[int, float]]     # name -> (launches, seconds)
    device_ops: List[Tuple[str, float]]       # top 10 by seconds
    idle_gaps: List[Tuple[str, float]]        # top 10 by seconds

    def launches(self, fragment: str) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name holds
        ``fragment``."""
        n, s = 0, 0.0
        for name, (k, sec) in self.kernels.items():
            if fragment in name:
                n, s = n + k, s + sec
        return n, s

    @property
    def kernel_seconds(self) -> float:
        return sum(sec for _, sec in self.kernels.values())


@contextlib.contextmanager
def profiled(enabled: bool, path: Path):
    """Profile the block when ``enabled``; yields a holder whose
    ``trace`` is the written trace's path afterwards."""
    holder = type("Traced", (), {"trace": None})()
    if not enabled:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_RANGE):
            yield holder
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    holder.trace = path


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def summarize(path: Path, steps: int) -> Optional[Summary]:
    """Reduce a written trace; None when it holds no window or no device
    operation (the profiler saw no device)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = next(((e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("ph") == "X" and e.get("name") == WINDOW_RANGE
                 and e.get("cat") == "user_annotation"), None)
    if span is None:
        return None
    w0, w1 = span
    ops, host = [], []
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("ph") != "X":
            continue
        a, b = e["ts"], e["ts"] + e.get("dur", 0)
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            ops.append((a, b))
            entry = kernels[e["name"]]
            entry[0] += 1
            entry[1] += (b - a) * 1e-6
        elif cat in HOST_CATS and e.get("name") != WINDOW_RANGE:
            host.append((a, b, e["name"]))
    if not ops:
        return None
    busy = _union(ops)
    gaps = [(b0, a1) for (_, b0), (a1, _) in zip([(w0, w0)] + busy,
                                                  busy + [(w1, w1)])
            if a1 > b0]
    return Summary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        steps=steps,
        kernels={k: (int(v[0]), v[1]) for k, v in kernels.items()},
        device_ops=sorted(((_short(k), v[1]) for k, v in kernels.items()),
                          key=lambda kv: -kv[1])[:10],
        idle_gaps=_name_gaps(gaps, host))


def _name_gaps(gaps, host) -> List[Tuple[str, float]]:
    """The idle time by the host operation running at each gap: the
    GAPS_NAMED longest gaps one by one, the rest as one entry."""
    host.sort()
    starts = [h[0] for h in host]
    order = sorted(gaps, key=lambda g: g[0] - g[1])
    totals: Dict[str, float] = defaultdict(float)
    for a, b in order[:GAPS_NAMED]:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        name = "host: no recorded operation"
        for j in range(i, max(-1, i - SCAN_LIMIT), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        totals[_short(name)] += (b - a) * 1e-6
    rest = sum(b - a for a, b in order[GAPS_NAMED:]) * 1e-6
    if rest > 0:
        totals[f"gaps shorter than the {GAPS_NAMED} longest"] += rest
    return sorted(totals.items(), key=lambda kv: -kv[1])[:10]
