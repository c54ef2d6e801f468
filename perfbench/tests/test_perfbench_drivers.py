"""Each driver's dry run on the CPU at a tiny size: the result line's
keys, no device metric without a card, and ``correct`` false under each
fault a cell can have, planted in the port underneath an otherwise
whole run, and under the control (the reference one precision below
the configuration's, in the port's place)."""
import json
import math

import pytest
import torch

from conftest import dry_run, tiny_cell
from perfbench.harness import check, readings

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checked"]
FLAT = ["kdda-8w64b.all_edges", "kdda-8w64b.band_edges"]
TRAIN = ["minicpm3-4b-l6.admm_2x512"]


def test_line_keys_and_no_device_metric_on_cpu(cell_name):
    line, _ = dry_run(cell_name, seconds=0.1)
    assert list(line) == KEYS
    assert line["metrics"] == {}
    assert line["device"]["platform"] == "cpu"
    assert line["correct"] is True
    json.dumps(line)


def test_traffic_overrides_the_admm_settings():
    """A traffic file may set the ADMM settings of its cell (a later cell
    with a longer delay ring is a data file)."""
    line, out = dry_run("kdda-8w64b.all_edges", seconds=0.1,
                        admm={"max_delay": 3})
    assert line["correct"], line["checked"]


@pytest.fixture
def unchanged_state(monkeypatch):
    """The epoch returns the state it was given (one step on)."""
    import repro_torch.api as api
    import repro_torch.training.trainer as trainer
    real = api.asybadmm_epoch

    def stuck(spec, state, data):
        _, info = real(spec, state, data)
        return state._replace(t=state.t + 1), info
    monkeypatch.setattr(api, "asybadmm_epoch", stuck)
    monkeypatch.setattr(trainer, "asybadmm_epoch", stuck)


@pytest.fixture
def half_batch(monkeypatch):
    """Each worker's gradient from half of its batch: the flat solve's
    second half of workers reuse the first half's data; a training
    batch keeps its first half of sequences (or of tokens), whose mean
    loss stands for the whole."""
    from repro_torch.core import space
    flat_real, tree_real = (space._PackedOps.worker_grads,
                            space.TreeSpace.worker_grads)

    def flat(self, loss_fn, z_tilde, data, *a, **k):
        n = data.shape[0] // 2
        data = torch.cat([data[:n], data[:data.shape[0] - n]])
        return flat_real(self, loss_fn, z_tilde, data, *a, **k)

    def tree(self, loss_fn, z_tilde, data, *a, **k):
        B, S = data["tokens"].shape[1:]
        cut = ((lambda v: v[:, :B // 2]) if B > 1
               else (lambda v: v[:, :, :S // 2]))
        return tree_real(self, loss_fn, z_tilde,
                         {key: cut(v) for key, v in data.items()}, *a, **k)
    monkeypatch.setattr(space._PackedOps, "worker_grads", flat)
    monkeypatch.setattr(space.TreeSpace, "worker_grads", tree)


@pytest.fixture
def altered_answer(monkeypatch):
    """One produced value altered: an element of each new z of the flat
    solve (B2's on one card, B3's on a mesh, in rank 0's process);
    worker 0's first token of a training step's batch."""
    from repro_torch.core import space
    from repro_torch.training.trainer import ADMMTrainer
    step_real = ADMMTrainer.train_step

    def altered(real):
        def server(self, *a, **k):
            z = real(self, *a, **k).clone()
            z[0, 0] += 1e-3
            return z
        return server

    def step(self, state, batch):
        if int(state.step) == 0:
            batch = dict(batch)
            tokens = batch["tokens"].clone()
            tokens[0, 0, 0] = (tokens[0, 0, 0] + 1) % 512
            batch["tokens"] = tokens
        return step_real(self, state, batch)
    for name in ("server_consensus_update", "server_prox"):
        monkeypatch.setattr(space._PackedOps, name,
                            altered(getattr(space._PackedOps, name)))
    monkeypatch.setattr(ADMMTrainer, "train_step", step)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_answer"])
def test_faults_are_not_correct(cell_name, fault, request):
    request.getfixturevalue(fault)
    line, _ = dry_run(cell_name, seconds=0.1)
    assert line["correct"] is False, (fault, line["checked"])


@pytest.mark.parametrize("name", FLAT + TRAIN)
def test_controls_and_faults_are_not_correct(name):
    """The control (the reference in bfloat16 for the flat solve, with
    TF32 products for training) and the training faults, each in the
    port's place: every reading fails one of the cell's limits."""
    cell = tiny_cell(name)
    for seed in (1, 2, 3):
        found = (readings.flat_readings(cell, seed, 200, "cpu")
                 if name in FLAT else readings.train_readings(cell, seed,
                                                              "cpu"))
        for mode, gaps in found:
            assert not all(c.ok for c in check.checks(gaps, cell.limits)), (
                mode, gaps)


def test_gaps_of_broken_numbers_are_infinite():
    assert check.loss_gap([math.nan], [1.0]) == math.inf
    assert check.norm_gap([1.0, math.nan], [1.0, 1.0]) == math.inf
    t = torch.ones(3)
    assert check.table_gap(t * math.nan, t) == math.inf
    assert check.table_gap(torch.ones(2), t) == math.inf
