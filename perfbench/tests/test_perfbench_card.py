"""Each cell's harness on the card at a tiny size: the window's events,
the traced run's reduction and every metric the manifest lists for the
cell. Skips without a CUDA card."""
import time

import pytest
import torch

from conftest import tiny_cell
from perfbench.harness import cell as cell_mod


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_cell_reports_its_metrics_on_the_card(cell_name, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    run = cell_mod.Run(cell=tiny_cell(cell_name), seed=2**31 + 1,
                       seconds=0.5, trace=trace,
                       device=torch.device("cuda", 0), t_start=time.time())
    out = cell_mod.execute(run)
    line = cell_mod.line(run, out)
    assert line["correct"], line["checked"]
    wanted = run.cell.per_layer if trace else run.cell.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in wanted}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10
