"""Tiny versions of the benchmark's cells for the CPU tests."""
import copy
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from perfbench.harness import cell as cell_mod  # noqa: E402
from perfbench.harness import manifest  # noqa: E402

# the port's MiniCPM3 smoke widths (configs/minicpm3_4b.py::smoke)
TINY_MLA = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=4, intermediate_size=256, vocab_size=512,
                q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16)


def tiny_cell(name: str, **overrides) -> manifest.Cell:
    """The cell ``name`` at a size the CPU runs in a second: widths and
    lengths cut (two workers a rank at the least), ``overrides`` over the
    traffic's, everything else as committed, its chips too (a cell on
    several runs one rank a chip, gloo ranks on the CPU)."""
    c = manifest.load_cell(name)
    cfg = copy.deepcopy(c.config)
    params = copy.deepcopy(c.params)
    if cfg["driver"] == "flat_solve":
        cfg.update(dim=3000, num_workers=max(4, 2 * c.chips), num_blocks=8)
        if params["edges"]["kind"] == "band":
            params["edges"] = {"kind": "band", "width": 4, "stride": 2}
    else:
        cfg.update(TINY_MLA)
        params["seq_len"] = 16
    params.update(overrides)
    return manifest.Cell(name=c.name, chips=c.chips, config=cfg,
                         workload=dict(c.workload, params=params),
                         end_to_end=c.end_to_end, per_layer=c.per_layer)


def dry_run(name: str, seed: int = 2**31 + 7, seconds: float = 0.3,
            **overrides):
    """One run of the tiny cell on the CPU: (result line, outcome)."""
    run = cell_mod.Run(cell=tiny_cell(name, **overrides), seed=seed,
                       seconds=seconds,
                       trace=False, device=torch.device("cpu"),
                       t_start=time.time())
    out = cell_mod.execute(run)
    return cell_mod.line(run, out), out


CELLS = [w["name"] for w in manifest.load_benchmark()["workloads"]]


@pytest.fixture(params=CELLS)
def cell_name(request):
    return request.param
