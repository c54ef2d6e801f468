"""One run of one cell: its driver runs set-up, the window and the
check; then the end-to-end metrics (``--trace 0``) or the per-layer
metrics that the readers under ``metrics/`` take from the trace
(``--trace 1``) go into the result line."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from . import manifest
from .check import Check
from .trace import Summary
from .window import Window
from ..counts import peaks as peak_table


FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX
    package, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass(frozen=True)
class Run:
    cell: manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                    # process start, on time.time()'s clock

    @property
    def trace_path(self) -> Path:
        return manifest.OUT_DIR / "traces" / f"{self.cell.name}.json"


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]      # every end-to-end value measured
    counts: Dict[str, float]          # the yardstick's counts of one step
    checks: List[Check]
    attempted: int                    # steps in the window
    failed: int                       # of them, steps with a non-finite loss
    memory_peak_bytes: Optional[int]
    window: Window
    summary: Optional[Summary]
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


def reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``."""
    path = manifest.BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def execute(run: Run) -> Outcome:
    driver = importlib.import_module(
        f"perfbench.drivers.{run.cell.config['driver']}")
    return driver.run(run)


def line(run: Run, out: Outcome) -> Dict[str, Any]:
    """The result line. Without a card no metric is reported: every
    metric is a device's. A step whose loss is not finite is a wrong
    answer, as is a compared number past its limit."""
    cell = run.cell
    cuda = run.device.type == "cuda"
    metrics: Dict[str, Any] = {}
    kind = torch.cuda.get_device_name(run.device) if cuda else "cpu"
    if cuda and not run.trace:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    elif cuda and out.summary is not None:
        peaks = peak_table.for_device(kind)
        for m in cell.per_layer:
            value = reader(m["name"])(out.summary, out.counts, peaks)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device: Dict[str, Any] = {
        "platform": "gpu" if cuda else "cpu", "kind": kind,
        "count": cell.chips if cuda else 0,
        "memory_peak_bytes": out.memory_peak_bytes}
    result: Dict[str, Any] = {
        "correct": out.failed == 0 and all(c.ok for c in out.checks),
        "attempted": out.attempted, "failed": out.failed,
        "metrics": metrics, "device": device}
    if cuda and run.trace and out.summary is not None:
        device["busy_s"] = out.summary.busy_s
        device["window_s"] = out.summary.window_s
        result["breakdown"] = {
            "device_ops": [list(kv) for kv in out.summary.device_ops],
            "idle_gaps": [list(kv) for kv in out.summary.idle_gaps]}
    result["checked"] = {c.name: {"value": c.value, "limit": c.limit}
                         for c in out.checks}
    return result
