"""Deterministic telemetry in the port (``repro_torch.obs``) against the
reference (``repro.obs``).

Pins: telemetry on leaves a run of the port's PS runtime unchanged (z
bitwise, delays, metrics, fold logs and makespan equal); the port's
streamed per-round records, Chrome trace and metrics equal the
reference's on the same chaos run (residuals at the reference's backend
tolerance, everything else exactly); ``core.metrics.block_residuals``
matches the reference's; and the numpy-level cases of
``tests/test_obs.py`` (hist, registry, span tracer,
sinks, record validation) hold for the port's copy.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as rapi
from repro import ps as rps
from repro.configs.base import ADMMConfig as RConfig
from repro.core import metrics as rmetrics
from repro.core.prox import make_prox as r_make_prox
from repro_torch import api as tapi
from repro_torch import ps as tps
from repro_torch.configs.base import ADMMConfig as TConfig
from repro_torch.core import metrics as tmetrics
from repro_torch.core.prox import make_prox as t_make_prox
from repro_torch.obs import (METRICS, ROUND_RECORD_SCHEMA, SPAN_NAMES,
                             TRACE_EVENT_KINDS, TRANSPORT_EVENT_KINDS,
                             CallbackSink, JsonlSink, MetricsRegistry,
                             SpanTracer, Telemetry, as_telemetry,
                             hist, make_sink, validate_record)

N, M, DBLK = 3, 4, 5
DIM = M * DBLK
ROUNDS = 8
TOL = dict(rtol=1e-5, atol=1e-6)

_r = np.random.RandomState(7)
CENTERS = _r.randn(N, DIM).astype(np.float32)
EDGE = np.array([[1, 1, 0, 1],
                 [1, 0, 1, 0],
                 [1, 1, 1, 1]], bool)
RHO_SCALE = np.array([0.5, 1.0, 2.0], np.float32)
CFG = dict(rho=2.0, gamma=0.1, max_delay=2, block_fraction=0.5,
           num_blocks=M, block_selection="cyclic", l1_coef=1e-3, clip=0.8,
           seed=0)


def _session(pkg):
    if pkg == "ref":
        return rapi.ConsensusSession.flat(
            lambda z, c: 0.5 * jnp.sum(jnp.square(z - c)),
            jnp.asarray(CENTERS), dim=DIM, cfg=RConfig(**CFG), edge=EDGE,
            rho_scale=RHO_SCALE)
    return tapi.ConsensusSession.flat(
        lambda z, c: 0.5 * torch.sum(torch.square(z - c)),
        torch.as_tensor(CENTERS), dim=DIM, cfg=TConfig(**CFG), edge=EDGE,
        rho_scale=RHO_SCALE, device="cpu")


def _runtime(pkg, **kw):
    ps = rps if pkg == "ref" else tps
    sess = _session(pkg)
    timing = ps.CostProfile(t_worker=ps.ParetoService(1.0, alpha=1.2),
                            t_server_block=ps.LognormalService(0.3, 0.4))
    chaos = ps.FaultPlan.of(ps.FaultPlan.crash(0, at=1.0, down=1.0),
                            ps.FaultPlan.slowdown(2, at=0.5, duration=2.0,
                                                  factor=3.0))
    return ps.PSRuntime(sess.spec, data=sess.data, timing=timing,
                        faults=chaos, **kw)


def _per_round_folds(rt):
    out = {}
    for dom in rt.domains:
        rounds = {}
        for (v, i, j) in dom.fold_log:
            rounds.setdefault(v, []).append((i, j))
        out[dom.sid] = {v: sorted(fs) for v, fs in rounds.items()}
    return out


# ---------------------------------------------------------------------------
# the determinism contract, and parity with the reference's telemetry
# ---------------------------------------------------------------------------

def test_telemetry_is_inert_under_chaos(tmp_path):
    rt_off = _runtime("port")
    off = rt_off.run(ROUNDS)
    tel = Telemetry(spans=True, sink=str(tmp_path / "rounds.jsonl"),
                    trace_path=str(tmp_path / "run.trace.json"))
    rt_on = _runtime("port", telemetry=tel)
    on = rt_on.run(ROUNDS)

    assert on.makespan == off.makespan
    for a, b in zip(on.z_versions, off.z_versions):
        assert torch.equal(a, b)
    assert list(on.metrics) == list(off.metrics)
    assert on.metrics == off.metrics
    assert _per_round_folds(rt_on) == _per_round_folds(rt_off)
    np.testing.assert_array_equal(on.trace.delays, off.trace.delays)
    assert on.trace.events == off.trace.events
    assert on.telemetry is tel and off.telemetry is None


def _close_nested(a, b, path="record"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close_nested(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close_nested(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        np.testing.assert_allclose(a, b, err_msg=path, **TOL)
    else:
        assert a == b, path


def test_streamed_records_and_spans_match_reference(tmp_path):
    """The same chaos run streams the same records (losses and the
    per-block stationarity at the reference's tolerance, counts and
    times exactly) and the same Chrome trace, and ends with the same
    metrics."""
    outs = {}
    for pkg in ("ref", "port"):
        mod = rps if pkg == "ref" else tps
        obs_mod = __import__("repro.obs" if pkg == "ref"
                             else "repro_torch.obs", fromlist=["Telemetry"])
        records = []
        tel = obs_mod.Telemetry(spans=True, sink=records.append,
                                trace_path=str(tmp_path / f"{pkg}.json"))
        res = _runtime(pkg, telemetry=tel).run(ROUNDS)
        assert isinstance(res, mod.PSRunResult)
        outs[pkg] = (records, res,
                     json.loads((tmp_path / f"{pkg}.json").read_text()))
    (r_rec, r_res, r_doc), (t_rec, t_res, t_doc) = outs["ref"], outs["port"]
    assert len(t_rec) == ROUNDS
    for rec in t_rec:
        validate_record(rec)
        assert set(ROUND_RECORD_SCHEMA) <= set(rec)
        assert rec["stationarity"] is not None
    _close_nested(r_rec, t_rec)
    assert t_res.metrics == r_res.metrics
    assert t_doc["traceEvents"] == r_doc["traceEvents"]
    assert t_doc["otherData"] == r_doc["otherData"]


def test_block_residuals_match_reference():
    rng = np.random.RandomState(3)
    Nw, Mb, d = 3, 4, 128
    z = rng.randn(Mb, d).astype(np.float32)
    y, x, g = (rng.randn(Nw, Mb, d).astype(np.float32) for _ in range(3))
    rho = np.array([0.5, 1.0, 2.0], np.float32)
    ref = rmetrics.block_residuals(jnp.asarray(z), jnp.asarray(y),
                                   jnp.asarray(x), EDGE, jnp.asarray(rho),
                                   reg=r_make_prox(1e-3, 0.8),
                                   grads=jnp.asarray(g))
    got = tmetrics.block_residuals(
        torch.as_tensor(z), torch.as_tensor(y), torch.as_tensor(x),
        torch.as_tensor(EDGE), torch.as_tensor(rho),
        reg=t_make_prox(1e-3, 0.8), grads=torch.as_tensor(g))
    for k in ("primal", "prox", "grad", "P"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)
    bare = tmetrics.block_residuals(torch.as_tensor(z), torch.as_tensor(y),
                                    torch.as_tensor(x), torch.as_tensor(EDGE),
                                    2.0)
    assert bare["prox"] is None and bare["grad"] is None
    np.testing.assert_allclose(bare["P"].numpy(),
                               np.square(bare["primal"].numpy()), **TOL)


def test_metrics_every_cadence():
    records = []
    tel = Telemetry(spans=False, sink=records.append, metrics_every=3)
    _runtime("port", telemetry=tel).run(ROUNDS)
    assert [r["round"] for r in records] == [0, 3, 6, ROUNDS - 1]
    with pytest.raises(ValueError, match="metrics_every"):
        _runtime("port", metrics_every=2)
    with pytest.raises(ValueError, match="metrics_every"):
        Telemetry(metrics_every=0)


def test_session_level_telemetry_coercion():
    records = []
    res = _session("port").run_ps(ROUNDS, telemetry=records.append)
    assert len(records) == ROUNDS
    for rec in records:
        validate_record(rec)
    assert res.telemetry is not None
    assert res.telemetry.spans is not None and len(res.telemetry.spans) > 0
    assert res.telemetry.events_seen == res.metrics["events"]
    assert as_telemetry(None) is None and as_telemetry(False) is None
    tel = Telemetry(spans=False)
    assert as_telemetry(tel) is tel
    assert as_telemetry(True).sink is None
    assert isinstance(as_telemetry("stdout"), Telemetry)


# ---------------------------------------------------------------------------
# the numpy-level layers (the port's own copy of repro.obs)
# ---------------------------------------------------------------------------

def test_hist_matches_numpy_on_generic_input():
    vals = [0.0, 1.0, 2.5, 2.5, 7.0]
    h = hist(vals, bins=4)
    counts, edges = np.histogram(vals, bins=4)
    assert h["counts"] == counts.tolist()
    np.testing.assert_allclose(h["edges"], edges)


@pytest.mark.parametrize("vals,lo,hi,total", [([], 0.0, 1.0, 0),
                                              ([3.0, 3.0, 3.0], 2.5, 3.5, 3)])
def test_hist_degenerate_inputs(vals, lo, hi, total):
    h = hist(vals, bins=8)
    assert sum(h["counts"]) == total
    assert h["edges"][0] == pytest.approx(lo)
    assert h["edges"][-1] == pytest.approx(hi)
    assert (np.diff(h["edges"]) > 0).all()
    with pytest.raises(ValueError, match="bins"):
        hist([1.0], bins=0)


def test_registry_validation_and_order():
    reg = MetricsRegistry()
    with pytest.raises(ValueError, match="not declared"):
        reg.counter("totally_new_metric", lambda: 0)
    reg.counter("totally_new_metric", lambda: 0, check=False)
    with pytest.raises(ValueError, match="declared as a gauge"):
        reg.counter("makespan", lambda: 0.0)
    reg.gauge("makespan", lambda: 1.0)
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("makespan", lambda: 8.0)
    with pytest.raises(ValueError, match="unknown instrument kind"):
        reg.register("events", "dial", lambda: 0)
    reg.counter("events", lambda: 2)
    reg.counter("commits", lambda: 3)
    assert list(reg.collect()) == ["totally_new_metric", "makespan",
                                   "events", "commits"]
    assert reg.collect(["commits"]) == {"commits": 3}
    assert reg.get("events").unit == METRICS["events"][1]
    assert all(row["help"] for row in reg.describe()[1:])


def test_span_tracer_rejects_unknown_and_mistyped_names():
    tr = SpanTracer()
    with pytest.raises(ValueError, match="unknown span kind"):
        tr.complete("worker 0", "made_up_span", 0.0, 1.0)
    with pytest.raises(ValueError, match="declared as"):
        tr.complete("worker 0", "commit", 0.0, 1.0)
    with pytest.raises(ValueError, match="ends before"):
        tr.complete("worker 0", "pull", 2.0, 1.0)
    tr.complete("worker 0", "pull", 1.0, 2.0, round=0)
    tr.instant("server 0", "commit", 2.0, version=1)
    tr.counter("server 0", "queue_depth", 2.0, depth=3)
    assert len(tr) == 3
    doc = tr.to_chrome({"seed": 0})
    assert [e["ph"] for e in doc["traceEvents"][:2]] == ["M", "M"]
    assert doc["otherData"] == {"seed": 0}


def test_trace_event_kinds_validated():
    tr = tps.DelayTrace.empty(2, N, M, bound=2)
    tr.add_event("crash", time=1.0, worker=0)
    with pytest.raises(ValueError, match="unknown trace event kind"):
        tr.add_event("meteor_strike", time=1.0)
    tr.add_transport("drop", time=1.0, worker=0)
    with pytest.raises(ValueError, match="unknown transport event kind"):
        tr.add_transport("wormhole", time=1.0)
    for kind in TRANSPORT_EVENT_KINDS:
        assert SPAN_NAMES[kind][0] == "instant"
    assert {"crash", "rejoin"} <= TRACE_EVENT_KINDS


def test_make_sink_coercion(tmp_path, capsys):
    assert make_sink(None) is None
    sink = make_sink(str(tmp_path / "out.jsonl"))
    assert isinstance(sink, JsonlSink)
    sink.emit({"round": 0})
    sink.close()
    assert json.loads((tmp_path / "out.jsonl").read_text()) == {"round": 0}
    got = []
    cb = make_sink(got.append)
    assert isinstance(cb, CallbackSink)
    cb.emit({"round": 1})
    assert got == [{"round": 1}]
    make_sink("stdout").emit({"round": 2})
    assert json.loads(capsys.readouterr().out) == {"round": 2}
    with pytest.raises(TypeError, match="sink"):
        make_sink(42)


def test_validate_record_names_offending_key():
    good = {"round": 0, "version": 1, "sim_time": 1.0, "loss": 0.5,
            "stationarity": None, "queue_depth": [0], "commits": 1,
            "pushes": 2, "stall_count": 0, "stall_time": 0.0,
            "transport": None}
    assert validate_record(dict(good)) == good
    with pytest.raises(ValueError, match="'commits'"):
        validate_record({**good, "commits": "three"})
    missing = dict(good)
    del missing["loss"]
    with pytest.raises(ValueError, match="'loss'"):
        validate_record(missing)
    with pytest.raises(ValueError, match="per_block"):
        validate_record({**good, "stationarity": {"P": 1.0}})
