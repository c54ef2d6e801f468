"""The port's dry run (``repro_torch/launch/dryrun.py``), its peak-memory
tracker (``analysis/cost.py``) and its table (``analysis/report.py``).

The rows mirror the reference's ``tests/test_dryrun.py`` at full width,
counted on the meta device over abstract production meshes: granite's
``train_4k``, mamba2's ``long_500k`` and qwen3's ``prefill_32k`` on the
pod, qwen3's ``train_4k`` ``sharded_epoch`` and ``cyclic`` (the block
round) and its ``decode_32k`` on the multi-pod. Each is cut to LAYERS
layers a stack (``run_one(..., layers=)``; every width is the
published one): the count's cost is per op, and a full-depth train row
takes seconds; ``main --mesh both`` and ``chip_smoke.py``'s ``dryrun``
line count full depth. The reference's module is never imported here: it sets
``XLA_FLAGS`` to 512 host devices at import, and its lowerings fail with
the installed jax, so no compiled number of it is a parity target; its
placement rules are, in ``test_torch_shardings.py``.
"""
import json
import math

import pytest
import torch

from repro_torch.analysis import report
from repro_torch.analysis.cost import count
from repro_torch.analysis.roofline import CARD_MEMORY_BYTES
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke
from repro_torch.configs.base import ADMMConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_abstract_mesh

LAYERS = 2
ROOFLINE_KEYS = ("arch", "shape", "mesh", "chips", "t_compute_s",
                 "t_memory_s", "t_collective_s", "bottleneck",
                 "step_time_bound_s", "useful_flops_ratio", "mfu_bound",
                 "flops_per_device", "hbm_bytes_per_device",
                 "collective_bytes_per_device")


def _check_row(row, program):
    assert row["status"] == "ok", row
    assert row["flops_per_device"] > 0 and row["hbm_bytes_per_device"] > 0
    for k in ROOFLINE_KEYS:
        assert k in row, k
    assert row["program"] == program
    mem = row["memory"]
    assert set(mem) == {"per_device_state_bytes", "spec_argument_bytes",
                        "peak_bytes"}
    assert mem["peak_bytes"] >= mem["per_device_state_bytes"] > 0
    assert row["fits"] == (mem["peak_bytes"] <= CARD_MEMORY_BYTES)
    assert isinstance(row["ignored_tokens"], list)
    for k in ("xla_cost_analysis", "hlo_bytes", "collectives_unscaled",
              "compile_s"):
        assert k not in row
    assert row["build_s"] >= 0 and row["count_s"] > 0
    json.dumps(row)


def _train_kernels(row):
    ops = row["op_counts"]
    assert (ops["B1"], ops["B2"], ops["B3"]) == (1, 0, 1)
    assert row["collectives"]["total"] == sum(
        v for k, v in row["collectives"].items() if k != "total") > 0
    assert 0.0 < row["layout_padding"] < 1.0


@pytest.mark.parametrize("arch,shape,mesh,variant,program", [
    ("granite-moe-1b-a400m", "train_4k", "pod", "baseline", "spmd_epoch"),
    ("mamba2-370m", "long_500k", "pod", "baseline", "replica"),
    ("qwen3-1.7b", "prefill_32k", "pod", "baseline", "replica"),
    ("qwen3-1.7b", "train_4k", "pod", "sharded_epoch", "spmd_epoch"),
    ("qwen3-1.7b", "train_4k", "pod", "cyclic", "block_round"),
    ("qwen3-1.7b", "decode_32k", "multipod", "baseline", "replica"),
])
def test_dryrun_row_at_full_width(arch, shape, mesh, variant, program):
    """Each row counts ok on meta, with FLOPs, the memory keys, ``fits``
    and the program; a train row launches B1 and B3 once and B2 never,
    and charges its collectives; the block round launches no kernel and
    reduces over data and model; a serving row has no collective."""
    row = dryrun.run_one(arch, shape, mesh, variant, layers=LAYERS)
    _check_row(row, program)
    assert (row["arch"], row["shape"], row["mesh"], row["variant"],
            row["layers"]) == (arch, shape, mesh, variant, LAYERS)
    if program == "spmd_epoch":
        _train_kernels(row)
        assert row["chips"] == 256
        assert row["reference_program"] == (
            "sharded_epoch" if variant == "sharded_epoch" else "gspmd")
    elif program == "block_round":
        assert all(row["op_counts"][b] == 0 for b in dryrun.KERNEL_IDS.values())
        assert row["collectives"]["all-gather"] > 0       # z~ over model
        assert row["collectives"]["all-reduce"] > 0       # w_sum, loss
        assert row["ignored_tokens"] == []
        assert 0.0 < row["layout_padding"] < 1.0
    else:
        assert row["collectives"] == {"total": 0}
        assert row["layout_padding"] is None
    if variant == "sharded_epoch":
        # the reference's packed-state placement is what a rank holds
        assert row["memory"]["spec_argument_bytes"] == \
            row["memory"]["per_device_state_bytes"]
    if shape == "decode_32k":
        assert row["chips"] == 512                # 128 / 32: 4 a rank


def test_flash_prefill_launches_b7_once_a_layer():
    """A flash prefill of prefill_32k's share of one rank (2 x 32768 on
    the pod) dispatches B7 once a layer."""
    cfg = dryrun.cut_depth(get_config("qwen3-1.7b"), LAYERS).with_(
        attn_impl="flash")
    program = dryrun.build_prefill(cfg, INPUT_SHAPES["prefill_32k"],
                                   dryrun.abstract_mesh("pod"))
    assert program.args[1].shape == (2, 32768)
    with torch.no_grad():
        cost = count(program.fn, *program.args)[1]
    assert cost.ops["flash_attention"] == cfg.num_layers


def test_skip_reason_matches_the_reference_cases():
    """tests/test_dryrun.py::test_long500k_skips_full_attention's cases;
    a skipped row carries its reason."""
    assert dryrun.skip_reason("qwen1.5-32b", "long_500k") is not None
    assert dryrun.skip_reason("mamba2-370m", "long_500k") is None
    assert dryrun.skip_reason("mixtral-8x7b", "long_500k") is None  # SWA
    assert dryrun.skip_reason("zamba2-1.2b", "long_500k") is None   # hybrid
    assert dryrun.skip_reason("qwen1.5-32b", "train_4k") is None
    row = dryrun.run_one("qwen1.5-32b", "long_500k", "pod")
    assert row["status"] == "skipped" and row["reason"]


def test_variant_tokens_are_honoured_or_listed(tmp_path):
    """A token that changes nothing in the port is listed in
    ``ignored_tokens``: decode ignores every token, as the reference's
    ``build_decode`` does; ``act_replicated`` has no meaning without
    GSPMD. ``main`` writes the rows as JSON lines, anew unless
    ``--append``, and ``report`` renders them."""
    out = tmp_path / "rows.jsonl"
    out.write_text("a row of another run\n")
    argv = ["--arch", "mamba2-370m", "--shape", "decode_32k", "--mesh",
            "pod", "--variant", "fsdp+act_replicated", "--layers",
            str(LAYERS), "--out", str(out)]
    assert dryrun.main(argv) == 0
    row = json.loads(out.read_text())           # the one row: replaced
    _check_row(row, "replica")
    assert row["layers"] == LAYERS
    assert row["ignored_tokens"] == ["act_replicated", "fsdp"]
    rows = report.load(str(out), "fsdp+act_replicated")
    table = report.dryrun_table(rows, "pod")
    assert "| mamba2-370m | decode_32k | ok | replica |" in table
    assert "count (s)" in table
    assert dryrun.main(argv + ["--append"]) == 0
    assert [json.loads(x)["arch"] for x in
            out.read_text().splitlines()] == ["mamba2-370m"] * 2


def test_peak_tracker_on_a_hand_reckoned_program():
    """Each storage once: an intermediate freed mid-way leaves, a view
    and an in-place op add nothing, the arguments count from the start;
    the same on the CPU and on meta."""
    def prog(x):
        a = x * 2                       # 4000 bytes
        b = a.view(10, 100)             # a view: nothing
        b.add_(1)                       # in place: nothing
        c = a + 1                       # 4000: x, a, c alive = 12000
        del a, b
        d = c * 3                       # a freed: x, c, d = 12000
        return d.sum()                  # + 4 bytes
    for dev in ("cpu", "meta"):
        _, cost = count(prog, torch.ones(1000, device=dev))
        assert cost.peak_bytes == 12004


def test_peak_tracker_same_on_cpu_and_meta():
    """The smoke train step's shard (qwen3 smoke, N = M = 4 on data 2 x
    model 2, rank 3's view, the plain ``torch`` backend: the CPU has no
    kernel) tracked on CPU tensors and on meta: the same peak, and the
    same bytes held."""
    cfg = get_smoke("qwen3-1.7b")
    mesh = make_abstract_mesh((2, 2), ("data", "model"), rank=3)
    acfg = ADMMConfig(rho=5.0, gamma=0.01, num_blocks=4, max_delay=1,
                      block_fraction=1.0)
    peaks, held = {}, {}
    for dev in ("cpu", "meta"):
        fn, args, _ = dryrun.train_program(cfg, mesh, acfg, 2, 16,
                                           device=dev, workers=4,
                                           backend="torch")
        peaks[dev] = count(fn, *args)[1].peak_bytes
        held[dev] = dryrun.held_bytes(args)
    assert peaks["cpu"] == peaks["meta"] > held["meta"] == held["cpu"] > 0
    assert math.isfinite(peaks["cpu"])
