"""The driver a workload names, and ``spmd_solve`` on the CPU: four gloo
ranks at a tiny flat size, sound, traced and under the bf16 control, and
the SPMD cell's counts and readers. The faults are in
``test_perfbench_spmd_faults.py``."""
import dataclasses
import time

import pytest
import torch

from conftest import tiny_cell
from perfbench.counts import flat as flat_counts
from perfbench.counts import spmd as spmd_counts
from perfbench.drivers import spmd_solve
from perfbench.harness import cell as cell_mod
from perfbench.harness import check, counted, manifest, readings, trace
from spmd_faults import SPMD, four_rank_cell, run_four, spmd_cell


def test_each_cell_resolves_to_its_driver():
    drivers = {w["name"]: manifest.load_cell(w["name"]).driver
               for w in manifest.load_benchmark()["workloads"]}
    assert drivers == {"kdda-8w64b.all_edges": "flat_solve",
                       "kdda-8w64b.band_edges": "flat_solve",
                       "minicpm3-4b-l6.admm_2x512": "admm_train"}
    assert spmd_cell().driver == "spmd_solve"
    assert spmd_cell().config["driver"] == "flat_solve"
    assert cell_mod.drivers() == ["admm_train", "flat_solve", "spmd_solve"]


def test_an_unknown_driver_names_the_drivers():
    c = tiny_cell("kdda-8w64b.all_edges")
    c = dataclasses.replace(c, workload=dict(c.workload, driver="nope"))
    run = cell_mod.Run(cell=c, seed=1, seconds=0.1, trace=False,
                       device=torch.device("cpu"), t_start=time.time())
    with pytest.raises(ValueError, match="unknown driver 'nope'.*"
                       "admm_train.*flat_solve.*spmd_solve"):
        cell_mod.execute(run)


def test_four_ranks_are_correct():
    line, out = run_four()
    assert line["correct"], line["checked"]
    assert line["checked"]["z_rank_gap"]["value"] == 0.0
    assert out.attempted == out.window.steps > 0
    # warm-up, calibration and window, every one replayed
    params = four_rank_cell().params
    assert out.notes["epochs"] == (params["warmup_steps"]
                                   + params["calibration_steps"]
                                   + out.attempted)


def test_rank_zero_alone_runs_traced(tmp_path, monkeypatch):
    """With ``--trace 1`` rank 0 writes the one trace, where the harness
    reads it; on the CPU it holds no device operation, so no summary is
    reported."""
    monkeypatch.setattr(manifest, "OUT_DIR", tmp_path)
    run = cell_mod.Run(cell=four_rank_cell(), seed=2**31 + 13, seconds=0.2,
                       trace=True, device=torch.device("cpu"),
                       t_start=time.time())
    out = spmd_solve.run(run)
    assert cell_mod.line(run, out)["correct"]
    assert out.summary is None
    assert [p.relative_to(tmp_path) for p in tmp_path.rglob("*")
            if p.is_file()] == [run.trace_path.relative_to(tmp_path)]


def test_the_control_is_not_correct():
    """The reference in bfloat16 in the program's place fails a limit."""
    cell = four_rank_cell()
    for seed in (1, 2, 3):
        for mode, gaps in readings.flat_readings(cell, seed, 200, "cpu"):
            gaps["z_rank_gap"] = 0.0
            assert not all(c.ok for c in check.checks(gaps, cell.limits)), (
                mode, gaps)


def test_spmd_counts_by_hand():
    # rank 0 of 4 holds workers 0 and 1 of 8; M = 64, half selected
    edge = [[True] * 64] * 8
    c = spmd_counts.epoch(edge, 0.5, 128, True, range(2))
    row = 128 * 4
    assert c["selected_pairs"] == 64 and c["edge_pairs"] == 128
    assert c["b1_bytes"] == 6 * 2 * 64 * row
    assert c["b3_bytes"] == 3 * 64 * row and "b2_bytes" not in c
    # z~ 64 blocks + c 64 + y 64 + stale w 64 + writes 3 * 64 + z 64
    assert c["step_bytes"] == 512 * row
    assert c["step_flops"] == 10 * 64 * 128
    whole = flat_counts.epoch(edge[:2], 0.5, 128, True)
    assert {k: c[k] for k in ("step_bytes", "step_flops", "b1_bytes")} == {
        k: whole[k] for k in ("step_bytes", "step_flops", "b1_bytes")}


def test_the_spmd_readers():
    summary = trace.Summary(
        window_s=0.010, busy_s=0.009, steps=4,
        kernels={"ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)": (8, 0.002),
                 "prox_consensus_kernel(float4 const*)": (4, 0.0004),
                 "worker_select_update_kernel<true>": (4, 0.004)},
        device_ops=[], idle_gaps=[])
    peaks = {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 6.7e13}
    counts = {"b3_bytes": 0.000335e12}
    assert cell_mod.reader("allreduce_device_ms.spmd")(
        summary, counts, peaks) == pytest.approx(0.5)
    # 0.1 ms of bytes at the peak over 0.1 ms a launch
    assert cell_mod.reader("b3_roofline_pct.spmd")(
        summary, counts, peaks) == pytest.approx(100.0)
    bare = dataclasses.replace(summary, kernels={})
    assert cell_mod.reader("allreduce_device_ms.spmd")(
        bare, counts, peaks) is None
    assert cell_mod.reader("b3_roofline_pct.spmd")(
        bare, counts, peaks) is None


def test_the_counted_window_makes_its_count():
    seen = []
    win = counted.run(seen.append, 7, "cpu")
    assert seen == list(range(7)) and win.steps == 7
    assert win.step_ms is None and win.seconds >= 0
