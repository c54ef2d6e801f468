"""The port's training entry points on the CPU at smoke size:
``repro_torch.launch.train.main(argv)`` with both trainers, under the
PS runtime (its ``--profile-dir`` through ``torch.profiler``) and with
``--ckpt``; ``repro_torch.examples.train_transformer_admm.main`` with
``--quick``; the two MoE archs, the SSM arch, the hybrid arch, MLA
and enc-dec (whose batches carry the encoder's frames) through
``--arch``. Every JSON line must parse and every loss be finite; both
default to the card."""
import json

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_step, restore
from repro_torch.configs import get_smoke
from repro_torch.core.tree import tree_leaves
from repro_torch.examples import train_transformer_admm as example
from repro_torch.launch import train
from repro_torch.models.weights import stacked_params

SMOKE = ["--device", "cpu", "--steps", "6", "--log-every", "2"]


def _records(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("trainer", ["admm", "sgd"])
def test_launch_train_runs_both_trainers(trainer, capsys, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    losses = train.main(SMOKE + ["--trainer", trainer, "--ckpt", ckpt])
    out = capsys.readouterr().out
    recs = _records(out)
    assert [r["step"] for r in recs] == [0, 2, 4, 5]
    assert [r["loss"] for r in recs] == losses
    assert np.isfinite(losses).all()
    assert f"trainer={trainer}" in out
    cfg = get_smoke("qwen3-1.7b")
    like = stacked_params(cfg, 0, "cpu")
    params = restore(ckpt, like)
    assert load_step(ckpt) == 6
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(params), tree_leaves(like)))
    assert moved > 0.0


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x7b"])
def test_launch_train_runs_the_moe_archs(arch, capsys):
    """``--arch`` takes its choices from ``list_archs()``: both MoE
    smokes train 3 ADMM steps, the router's aux loss in every loss."""
    losses = train.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                         "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out
    assert [r["loss"] for r in _records(out)] == losses
    assert len(losses) == 3 and np.isfinite(losses).all()


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_launch_train_runs_the_ssm_and_hybrid_archs(arch, capsys):
    """mamba2's and zamba2's smokes (zamba2's unstacked shared block
    among the packed leaves) train 3 ADMM steps through ``--arch``."""
    losses = train.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                         "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out
    assert [r["loss"] for r in _records(out)] == losses
    assert len(losses) == 3 and np.isfinite(losses).all()


@pytest.mark.parametrize("arch,trainer,runtime", [
    ("minicpm3-4b", "admm", "epoch"), ("whisper-medium", "admm", "epoch"),
    ("whisper-medium", "sgd", "epoch"), ("whisper-medium", "admm", "ps")])
def test_launch_train_runs_the_mla_and_enc_dec_archs(arch, trainer, runtime,
                                                     capsys):
    """minicpm3's and whisper's smokes train 3 steps (or PS rounds)
    through ``--arch``; whisper's batches carry (B, T_enc, d) frames
    drawn by ``TokenPipeline``, which its loss needs (it raises
    without them)."""
    losses = train.main(["--arch", arch, "--device", "cpu", "--steps", "3",
                         "--log-every", "1", "--trainer", trainer,
                         "--runtime", runtime])
    out = capsys.readouterr().out
    assert f"arch={arch}-smoke" in out
    assert [r["loss"] for r in _records(out)[:3]] == losses
    assert len(losses) == 3 and np.isfinite(losses).all()


def test_launch_train_ps_runtime(capsys, tmp_path):
    prof = tmp_path / "prof"
    losses = train.main(["--device", "cpu", "--steps", "3", "--runtime",
                         "ps", "--log-every", "1", "--profile-dir",
                         str(prof), "--ckpt", str(tmp_path / "z")])
    recs = _records(capsys.readouterr().out)
    assert [r["round"] for r in recs[:3]] == [0, 1, 2]
    summary = recs[3]
    assert summary["runtime"] == "ps" and summary["rounds"] == 3
    assert summary["commits"] == 8 * 3          # --num-blocks 8
    assert losses == [r["loss"] for r in recs[:3]]
    assert np.isfinite(losses).all()
    assert list(prof.glob("*.pt.trace.json"))
    assert load_step(str(tmp_path / "z")) == 3


def test_launch_train_refusals(monkeypatch):
    with pytest.raises(SystemExit, match="use --trainer admm"):
        train.main(SMOKE + ["--trainer", "sgd", "--runtime", "ps"])
    with pytest.raises(SystemExit):
        train.main(SMOKE + ["--autotune", "tiles"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main(["--quick"])


def test_example_quick(capsys):
    losses = example.main(["--quick", "--device", "cpu"])
    recs = _records(capsys.readouterr().out)
    assert recs and all(np.isfinite(r["consensus_residual"]) for r in recs)
    for name in ("admm_loss", "adamw_loss"):
        assert len(losses[name]) == 30 and np.isfinite(losses[name]).all()
        assert np.mean(losses[name][-5:]) < np.mean(losses[name][:5])
