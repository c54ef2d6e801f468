"""The port's entry points against the reference's scripts:
``repro_torch.examples.quickstart``, ``repro_torch.examples.
sparse_logreg_admm``, ``repro_torch.benchmarks.convergence`` and
``repro_torch.examples.serve_decode`` against ``examples/quickstart.py``,
``examples/sparse_logreg_admm.py``, ``benchmarks/convergence.py`` and
``examples/serve_decode.py``, loaded by path and run as they are, on
the CPU.

The draw-free variants (``max_delay=0``, ``block_fraction=1``) run with
each side's own policies. The asynchronous ones draw delays and blocks,
which torch cannot reproduce from JAX's threefry, so both sides'
``ConsensusSession.flat`` is wrapped to pass the same recorded draws in
(``TraceDelay`` and a callable selector, keyed by the config's seed), as
``tests/test_torch_space.py`` does for the epoch. Objectives, P and the
KKT violations are held at rtol = atol = 1e-5, the reference's own
tolerance between its backends.
"""
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro.core import space as rspace
from repro.kernels import ops as rops
from repro_torch import api as tapi
from repro_torch.benchmarks import convergence
from repro_torch.core import space as tspace
from repro_torch.examples import quickstart, serve_decode, sparse_logreg_admm

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-5
ROUNDS = 640                 # recorded draws: more epochs than any run here


def _close(a, b, **kw):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                               atol=TOL, **kw)


def _load(rel: str):
    """The reference script at ``rel``, executed as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        "ref_" + Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _draws(cfg, n_workers):
    """Delays in [0, max_delay] (the bound reached once) and selections
    at the config's block fraction, from the config's seed."""
    M = cfg.num_blocks
    rng = np.random.RandomState(100 + cfg.seed)
    delays = rng.randint(0, cfg.max_delay + 1, size=(ROUNDS, n_workers, M))
    delays[0, 0, 0] = cfg.max_delay
    sels = rng.rand(ROUNDS, n_workers, M) < cfg.block_fraction
    return delays, sels


def _draw_free(cfg) -> bool:
    return cfg.max_delay == 0 and cfg.block_fraction == 1.0


@pytest.fixture
def injected(monkeypatch):
    """Wrap both packages' ``ConsensusSession.flat`` so an asynchronous
    config gets the same recorded draws on both sides, and record every
    reference ``run`` (session, state, history) in order."""
    runs = []
    for cls, space, as_sel in (
            (rapi.ConsensusSession, rspace, jnp.asarray),
            (tapi.ConsensusSession, tspace, torch.as_tensor)):
        orig = cls.flat

        def flat(loss_fn, data, dim, cfg=None, *, _orig=orig, _space=space,
                 _as=as_sel, **kw):
            if not _draw_free(cfg):
                delays, sels = _draws(cfg, data[0].shape[0])
                sel_t = _as(sels)
                kw.update(delay_model=_space.TraceDelay(delays),
                          selector=lambda ctx, _s=sel_t: _s[ctx.t] & ctx.edge)
            return _orig(loss_fn, data, dim, cfg, **kw)

        monkeypatch.setattr(cls, "flat", staticmethod(flat))
    run = rapi.ConsensusSession.run

    def recording_run(self, *args, **kw):
        state, hist = run(self, *args, **kw)
        runs.append((self, state, hist))
        return state, hist

    monkeypatch.setattr(rapi.ConsensusSession, "run", recording_run)
    return runs


def test_quickstart_matches_the_reference(injected, capsys):
    _load("examples/quickstart.py")
    (rsess, rstate, rhist), = injected
    port = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert port["backend"] == "torch"
    assert port["edge_density"] == pytest.approx(
        float(jnp.mean(rsess.spec.edge)))
    assert [h["epoch"] for h in port["history"]] == [100, 200, 300, 400,
                                                     500, 600]
    for p, r in zip(port["history"], rhist):
        _close(p["objective"], r["objective"], err_msg=f"epoch {r['epoch']}")
    assert port["history"][-1]["objective"] < port["objective_start"]
    _close(port["P"], float(rsess.stationarity(rstate)["P"]))
    rkkt = rsess.kkt_violations(rstate)
    assert set(port["kkt"]) == set(rkkt)
    for k, v in rkkt.items():
        _close(port["kkt"][k], float(v), err_msg=k)
    # the same printed lines, twice: the reference's, then the port's
    lines = out.splitlines()
    assert len(lines) == 2 * 11
    assert lines[0] == lines[11] == "edge density |E|/(N·M) = 0.62"
    assert [ln.split()[:2] for ln in lines[12:18]] == [
        ["epoch", str(e)] for e in (100, 200, 300, 400, 500, 600)]


def test_sparse_logreg_admm_matches_the_reference(injected, monkeypatch,
                                                  capsys):
    flags = ["--dim", "256", "--epochs", "50"]
    monkeypatch.setattr(sys, "argv", ["sparse_logreg_admm.py", *flags])
    _load("examples/sparse_logreg_admm.py").main()
    port = sparse_logreg_admm.main(flags + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert [r["name"] for r in port["rows"]] == list(
        sparse_logreg_admm.VARIANTS)
    assert len(injected) == len(port["rows"]) == 3
    for row, (rsess, rstate, rhist) in zip(port["rows"], injected):
        assert row["backend"] == "torch" and row["epochs"] == 50
        _close(row["objective"], rhist[-1]["objective"], err_msg=row["name"])
        _close(row["P"], float(rsess.stationarity(rstate)["P"]),
               err_msg=row["name"])
        assert row["objective"] < row["objective_start"]
    # the cross-check: the port's gradient against autograd and against
    # the reference's kernels (interpret mode) on the same worker data
    data = sparse_logreg_admm.make_data(256)
    check = port["crosscheck"]
    np.testing.assert_allclose(check["g_kernel"].numpy(),
                               check["g_auto"].numpy(), rtol=1e-4, atol=1e-5)
    ref_g = rops.logreg_grad(jnp.asarray(data.X[0]), jnp.asarray(data.y[0]),
                             jnp.zeros(256), interpret=True)
    np.testing.assert_allclose(check["g_kernel"].numpy(), np.asarray(ref_g),
                               rtol=1e-4, atol=1e-5)
    assert "plain logreg_grad vs autograd: max|Δ| = " in out
    assert out.count("sync (block, D=0)") == 2


def test_convergence_matches_the_reference(injected, monkeypatch):
    epochs, every = 20, 10
    ref = _load("benchmarks/convergence.py")
    recorded = []
    run_one = ref.run_one
    monkeypatch.setattr(ref, "EVAL_EVERY", every)
    monkeypatch.setattr(
        ref, "run_one",
        lambda sess: recorded.append(run_one(sess, epochs=epochs))
        or recorded[-1])
    ref_rows, port_rows = [], []
    ref.main(emit=ref_rows.append)
    port = convergence.main(emit=port_rows.append, epochs=epochs,
                            device="cpu", eval_every=every)
    assert [r["name"] for r in port] == [v[0] for v in convergence.VARIANTS]
    assert [row.split(",")[0] for row in port_rows] == [
        row.split(",")[0] for row in ref_rows]
    for p, (_, trace, P) in zip(port, recorded):
        assert p["backend"] == "torch" and len(p["trace"]) == 2
        _close(p["trace"], [float(x) for x in trace], err_msg=p["name"])
        _close(p["P"], P, err_msg=p["name"])
        assert p["us_per_call"] > 0


def test_serve_decode_matches_the_reference_lines(monkeypatch, capsys):
    """``serve_decode`` at its defaults: one line per arch of the
    reference's default list (one arch per family: dense, MoE, SSM,
    hybrid), in the reference's format (the mixtral and zamba2 lines
    against the reference script's own); the samples are the port's
    draws (temperature 0.7, seed 1), the same on a second run."""
    ref_lines = {}
    for arch in ("mixtral-8x7b", "zamba2-1.2b"):
        monkeypatch.setattr(sys, "argv", ["serve_decode.py", "--arch", arch])
        _load("examples/serve_decode.py").main()
        ref_lines[arch] = capsys.readouterr().out.splitlines()[-1]
    rows = serve_decode.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [r["arch"] for r in rows] == ["qwen3-1.7b", "mixtral-8x7b",
                                         "mamba2-370m", "zamba2-1.2b"]
    assert serve_decode.DEFAULT_ARCHS == [r["arch"] for r in rows]
    assert out == [r["line"] for r in rows]
    for i, arch in ((1, "mixtral-8x7b"), (3, "zamba2-1.2b")):
        assert out[i].split()[:3] == ref_lines[arch].split()[:3] == [
            arch, "64", "tokens"]
        assert out[i].index("sample:") == ref_lines[arch].index("sample:")
    for row in rows:
        assert row["tokens"].shape == (4, 16)
        assert row["tokens"].min() >= 0 and row["tokens"].max() < 512
        assert f"sample: {row['tokens'][0][:8].tolist()}" in row["line"]
    again = serve_decode.main(["--device", "cpu", "--arch",
                               "mixtral-8x7b"])
    np.testing.assert_array_equal(again[0]["tokens"], rows[1]["tokens"])


def test_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means CUDA; without a card each entry point
    raises rather than moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sparse_logreg_admm.main(["--dim", "256", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convergence.main(epochs=1, eval_every=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_decode.main([])
