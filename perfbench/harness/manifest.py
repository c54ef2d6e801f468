"""``BENCHMARK.json`` and the files it names, read into one ``Cell``.

A cell is one entry of ``workloads``: its configuration file (the sizes
as run), its workload file under ``workloads/`` (the traffic parameters
and the limits of its check, and optionally the driver that runs it)
and the metrics that apply to it, all found by name, so a later change
adds a cell with files and entries alone.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "perfbench"
OUT_DIR = BENCH_DIR / "out"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]          # the configuration file as run
    workload: Dict[str, Any]        # the workload file: params, limits
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def params(self) -> Dict[str, Any]:
        return self.workload["params"]

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]

    @property
    def driver(self) -> str:
        """The module under ``drivers/`` that runs the cell: the workload
        file's ``driver`` where it names one, else the configuration's."""
        return self.workload.get("driver", self.config["driver"])


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(w['name'] for w in bench['workloads'])}")
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    with open(root / config["file"]) as f:
        config_file = json.load(f)
    with open(root / "perfbench" / "workloads" / f"{name}.json") as f:
        workload = json.load(f)
    if workload["config"] != entry["config"]:
        raise SystemExit(f"{name}: workload file names config "
                         f"{workload['config']!r}, BENCHMARK.json "
                         f"{entry['config']!r}")
    return Cell(name=name, chips=int(entry["chips"]), config=config_file,
                workload=workload,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])
