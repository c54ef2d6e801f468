"""BENCHMARK.json against the benchmark's contract, and the files it
names: every name, unit and length in bounds, every metric's cells
present, every per-layer metric's ``moves`` reported where it is read."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden_size|intermediate_size|head_size"
                   r"|expand|num_experts_per_tok|latent|state_size")
METRIC_KEYS = {"name", "unit", "better", "source"}
# numbers compared exactly (limit 0): the ranks' agreement, which NCCL's
# all-reduce gives bitwise
EXACT = {"z_rank_gap"}


def short_line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    names = [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and set(names) == used
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and short_line(c["why"])
        assert short_line(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith("perfbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        assert (ROOT / "perfbench" / "drivers"
                / f"{data['driver']}.py").exists()
        assert (ROOT / "perfbench" / "reference"
                / f"{data['reference']}.py").exists()


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and short_line(w["why"])
        data = json.loads((ROOT / "perfbench" / "workloads"
                           / f"{w['name']}.json").read_text())
        assert (data["name"], data["config"], data["traffic"],
                data["chips"]) == (w["name"], w["config"], w["traffic"],
                                   w["chips"])
        assert data["limits"] and all(v > 0 or name in EXACT
                                      for name, v in data["limits"].items())


def applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e, layers = BENCH["end_to_end"], BENCH["per_layer"]
    names = [m["name"] for m in e2e + layers]
    assert len(names) == len(set(names))
    assert 1 <= len(e2e) <= 16 and 1 <= len(layers) <= 128
    assert "setup_s" in {m["name"] for m in e2e}
    for m in e2e:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layers:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert short_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
        moved = {x["name"]: x for x in e2e}[m["moves"]]
        for cell in m.get("workloads", cells):
            assert applies(moved, cell), (m["name"], cell)
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    layer_names = {}
    for m in layers:
        base = m["name"].split(".")[0]
        layer_names.setdefault(base, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layer_names.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_enough(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"] if applies(m, cell)]
    layers = [m for m in BENCH["per_layer"] if applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
