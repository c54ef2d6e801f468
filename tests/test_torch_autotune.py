"""The port's launch autotuner (``repro_torch.kernels.autotune``) on the
CPU: the reference's table key format, lookups and a stale entry
refused, the proxy's winner reproduced, ``resolve_autotune``'s errors,
the ``--smoke`` CLI, the kept table, the dispatch's lookup
(``_PackedOps._launch``), and "cached" / "sweep" sessions and
``launch.train --autotune`` giving "off"'s z and losses bitwise (on the
CPU the ops run their plain versions, which have no launch to vary; the
card's candidates are held bitwise in ``test_torch_kernels_cuda.py``)."""
import dataclasses
import json

import pytest
import torch

from repro_torch.api import ConsensusSession
from repro_torch.configs.base import ADMMConfig
from repro_torch.core.blocks import make_flat_blocks
from repro_torch.core.space import FlatSpace
from repro_torch.kernels import autotune
from repro_torch.launch import train

KDDA = (8, 64, 315_904)


@pytest.fixture
def table(tmp_path, monkeypatch):
    """A table file of the test's own, the module cache emptied around."""
    path = tmp_path / "tuned.json"
    monkeypatch.setenv("REPRO_TORCH_KERNELS_TUNED", str(path))
    monkeypatch.setattr(autotune, "_table_cache", None)
    yield path
    autotune._table_cache = None


def test_table_key_and_lookups(table):
    key = autotune.table_key("NVIDIA_H100_80GB_HBM3", "server_prox_fused",
                             8, 64, 315904)
    assert key == "NVIDIA_H100_80GB_HBM3|server_prox_fused|N8|M64|d315904|" \
                  "float32"
    assert autotune.parse_key(key) == ("NVIDIA_H100_80GB_HBM3",
                                       "server_prox_fused", 8, 64, 315904,
                                       "float32")
    assert autotune.device_kind("cpu") == autotune.device_kind("meta") == \
        "cpu"
    entries = {
        autotune.table_key("cpu", "worker_select_update", *KDDA):
            {"threads": 512, "blocks_per_sm": 4, "score_us": 1.5,
             "method": "proxy"},
        autotune.table_key("cpu", "server_prox_fused", *KDDA):  # stale
            {"threads": 1024, "blocks_per_sm": 4, "score_us": 1.0,
             "method": "proxy"},
        autotune.table_key("cpu", "worker_select_update", 2, 2, 128):
            {"threads": 96, "blocks_per_sm": 1, "score_us": 1.0,
             "method": "proxy"}}
    assert autotune.save_table(entries)
    assert set(json.loads(table.read_text())["entries"]) == set(entries)
    autotune._table_cache = None
    cfg = autotune.lookup("worker_select_update", *KDDA, dev="cpu")
    assert cfg == autotune.LaunchConfig(512, 4, 1.5, "proxy")
    assert autotune.lookup_tile("worker_select_update", *KDDA,
                                dev="cpu") == (512, 4)
    # 4096 resident threads an SM, a block size with no kernel: refused
    assert autotune.lookup("server_prox_fused", *KDDA, dev="cpu") is not None
    assert autotune.lookup_tile("server_prox_fused", *KDDA, dev="cpu") is None
    assert autotune.lookup_tile("worker_select_update", 2, 2, 128,
                                dev="cpu") is None
    # misses: another shape, another device
    assert autotune.lookup_tile("worker_select_update", 8, 64, 128,
                                dev="cpu") is None
    assert autotune.lookup_tile("worker_select_update", *KDDA,
                                dev="NVIDIA_H100_80GB_HBM3") is None


def test_proxy_winner_reproduced():
    """The winner is the least proxy score, ties going to the larger
    launch; the candidates stay within 2048 resident threads."""
    for op in autotune.OPS:
        for shape in autotune.SHAPES + ((3, 5, 256),):
            cands = autotune.launch_candidates(op, *shape)
            assert cands and all(t * b <= 2048 for t, b in cands)
            assert (128, 8) in cands and (1024, 4) not in cands
            scores = {c: autotune.proxy_score_us(op, *shape, *c)
                      for c in cands}
            best = min(scores.values())
            want = max(c for c, s in scores.items() if s == best)
            got = autotune.sweep_op(op, *shape)
            assert got.launch == want and got.method == "proxy"
            assert got.score_us == best
    # bytes over 3.35 TB/s plus a microsecond a wave of 132 SMs
    assert autotune.proxy_score_us("server_prox_fused", 8, 64, 315904, 128,
                                   1) == pytest.approx(
        (10 * 64 * 315904 * 4 + 8 * 64 + 4 * 64) / 3.35e6
        + -(-64 * 78976 // (128 * 132)))
    with pytest.raises(ValueError, match="lane-aligned"):
        autotune.launch_candidates("server_prox_fused", 2, 2, 100)


def test_resolve_autotune_errors():
    assert autotune.resolve_autotune(None) == "off"
    assert autotune.resolve_autotune("") == "off"
    for mode in autotune.MODES:
        assert autotune.resolve_autotune(mode) == mode
    with pytest.raises(ValueError, match="unknown autotune mode"):
        autotune.resolve_autotune("tiles")
    with pytest.raises(ValueError, match="float32"):
        autotune.sweep_op("server_prox_fused", 2, 2, 128, dtype="bfloat16")
    with pytest.raises(ValueError, match="CUDA"):
        autotune.sweep_op("server_prox_fused", 2, 2, 128,
                          measure="cuda_events")


def test_smoke_cli_and_the_kept_table(capsys):
    """The kept table: the cpu proxy entries are the proxy's winners, an
    H100's entries measured on the card, both ops at both benchmark
    shapes for each."""
    autotune._table_cache = None
    assert autotune.main(["--smoke", "--device", "cpu"]) == 0
    assert "smoke ok" in capsys.readouterr().out
    entries = autotune.load_table(refresh=True)
    for dev, method in (("cpu", "proxy"),
                        ("NVIDIA_H100_80GB_HBM3", "cuda_events")):
        for shape in autotune.SHAPES:
            for op in autotune.OPS:
                e = entries[autotune.table_key(dev, op, *shape)]
                assert e["method"] == method
                assert autotune.valid_launch(e["threads"], e["blocks_per_sm"])


def test_dispatch_looks_the_launch_up():
    """``_PackedOps._launch``: the kept entry of the bundle's device and
    shape under "cached", the default (None) under "off" or on a miss."""
    space = FlatSpace(blocks=make_flat_blocks(64 * 315904, 64),
                      num_workers=8, backend="cuda")
    bundle = torch.empty(KDDA, device="meta")
    assert space._launch("worker_select_update", bundle) is None
    cached = dataclasses.replace(space, autotune="cached")
    for op in autotune.OPS:
        assert cached._launch(op, bundle) == autotune.lookup_tile(
            op, *KDDA, dev="cpu") is not None
    assert cached._launch("server_prox_fused",
                          torch.empty((8, 64, 128), device="meta")) is None


def _quad(z, c):
    return 0.5 * torch.sum(torch.square(z - c))


def test_cached_and_sweep_sessions_match_off():
    centers = torch.randn((4, 1000), generator=torch.Generator().manual_seed(0))
    zs = {}
    for mode in autotune.MODES:
        cfg = ADMMConfig(rho=2.0, gamma=0.1, max_delay=1, block_fraction=0.5,
                         num_blocks=8, l1_coef=1e-3, clip=0.8, autotune=mode)
        sess = ConsensusSession.flat(_quad, centers, dim=1000, cfg=cfg,
                                     device="cpu")
        assert sess.spec.space.autotune == ("off" if mode == "off"
                                            else "cached")
        state = sess.init()
        for _ in range(4):
            state, _ = sess.step(state)
        zs[mode] = sess.z(state)
    assert torch.equal(zs["cached"], zs["off"])
    assert torch.equal(zs["sweep"], zs["off"])


def test_launch_train_autotune_matches_off(capsys):
    argv = ["--device", "cpu", "--steps", "2", "--log-every", "1"]
    losses = {mode: train.main(argv + ["--autotune", mode])
              for mode in autotune.MODES}
    assert losses["cached"] == losses["off"] == losses["sweep"]
    capsys.readouterr()
