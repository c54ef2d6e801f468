"""The port's unreliable transport (``repro_torch.ps.transport``) and the
trace file's error handling, against the reference's
``tests/test_ps_transport.py``.

Lossy runs (drop / dup / reorder with ack+retry, a ``link_loss`` burst,
loss with worker churn) take the reference's schedule exactly — the
same makespan, staleness, delivery log and metrics — and the
reference's z within its backend tolerance, and replay through the
port's epoch; the zero-knob transport is inert; the backoff ladder,
exactly-once folds, the divergence watchdog and the trace loader's
errors hold as in the reference. Random selections come from the
reference's engine (``test_torch_ps_pairs.inject_selection``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import test_torch_ps_pairs as pairs
from repro import ps as rps
from repro_torch import ps as tps
from repro_torch.benchmarks import speedup
from repro_torch.ps import (ConstantService, CostProfile, DelayTrace,
                            FaultPlan, NetworkModel, PSRuntime, Transport,
                            as_network)

N, M, ROUNDS = pairs.N, pairs.M, pairs.ROUNDS


def _lossy(ps):
    return ps.Transport(0.0, 0.0, drop_rate=0.1, dup_rate=0.05,
                        reorder_rate=0.2, ack_timeout=0.5)


def _pair_runs(monkeypatch, rounds=ROUNDS, plan=None, timing="pareto",
               transport=True):
    ref, port = pairs.sessions("random")
    pairs.inject_selection(monkeypatch, ref)
    out = []
    for sess, ps, t in zip((ref, port), (rps, tps), pairs.timings(timing)):
        faults = None if plan is None else plan(ps)
        out.append(sess.run_ps(rounds, timing=t, faults=faults,
                               transport=_lossy(ps) if transport else None))
    return out


# ---------------------------------------------------------------------------
# lossy runs: the reference's schedule and z
# ---------------------------------------------------------------------------

def test_lossy_run_matches_reference_and_replays(monkeypatch):
    r, t = _pair_runs(monkeypatch)
    pairs.assert_same_schedule(r, t)
    pairs.assert_same_z(r, t)
    assert t.metrics["transport"]["drops"] > 0
    monkeypatch.undo()                       # the port's own selection
    _, port = pairs.sessions("random")
    own = port.run_ps(ROUNDS, timing=pairs.timings("pareto")[1],
                      transport=_lossy(tps))
    _, replay = pairs.sessions("random",
                               delay_models=(None, own.to_delay_model()))
    pairs.assert_replays(own, replay)


def test_tree_lossy_run_matches_reference_and_replays(monkeypatch):
    """A pytree session under the lossy transport
    (tests/test_ps_transport.py:124)."""
    ref, port = pairs.sessions("random", tree=True)
    pairs.inject_selection(monkeypatch, ref)
    (rb, tb), (rt, tt) = pairs.batches(), pairs.timings("pareto")
    r = ref.run_ps(ROUNDS, timing=rt, transport=_lossy(rps), batches=rb)
    t = port.run_ps(ROUNDS, timing=tt, transport=_lossy(tps), batches=tb)
    pairs.assert_same_schedule(r, t)
    pairs.assert_same_z(r, t)
    assert t.metrics["transport"]["drops"] > 0
    monkeypatch.undo()
    own = port.run_ps(ROUNDS, timing=tt, transport=_lossy(tps), batches=tb)
    _, replay = pairs.sessions("random", tree=True,
                               delay_models=(None, own.to_delay_model()))
    pairs.assert_replays(own, replay, batch=tb(0))


@pytest.mark.parametrize("plan", [
    lambda ps: ps.FaultPlan.of(ps.FaultPlan.link_loss(1.0, 4.0, 0.5)),
    lambda ps: ps.FaultPlan.of(ps.FaultPlan.link_loss(0.5, 5.0, 0.4),
                               ps.FaultPlan.crash(1, 3.0, 4.0))],
    ids=["link_loss", "link_loss_churn"])
def test_link_loss_matches_reference(monkeypatch, plan):
    r, t = _pair_runs(monkeypatch, rounds=ROUNDS + 2, plan=plan,
                      transport=False)
    pairs.assert_same_schedule(r, t)
    pairs.assert_same_z(r, t)
    assert any(e["kind"] == "link_loss" for e in t.trace.events)


def test_lossy_scenario_gates_on_cpu():
    assert speedup.lossy_scenario(lambda line: None, smoke=True,
                                  device="cpu")


# ---------------------------------------------------------------------------
# zero-loss inertness and the reliability layer
# ---------------------------------------------------------------------------

def test_zero_loss_transport_is_inert():
    _, port = pairs.sessions("random")
    timing = pairs.timings("pareto")[1]
    base = port.run_ps(ROUNDS, timing=timing)
    inert = port.run_ps(ROUNDS, timing=dataclasses.replace(
        timing, net=Transport(0.0, 0.0)))
    np.testing.assert_array_equal(base.trace.delays, inert.trace.delays)
    for a, b in zip(base.z_versions, inert.z_versions):
        assert torch.equal(a, b)
    assert base.makespan == inert.makespan
    assert "transport" not in inert.metrics and not inert.trace.transport
    net = port.run_ps(ROUNDS, timing=CostProfile(net=NetworkModel(0.3, 0.1)))
    tr = port.run_ps(ROUNDS, timing=CostProfile(net=Transport(0.3, 0.1)))
    np.testing.assert_array_equal(net.trace.delays, tr.trace.delays)
    assert torch.equal(net.z_final, tr.z_final)
    assert net.makespan == tr.makespan


def test_transport_validation_and_backoff():
    assert as_network(None) is None and as_network(0.0) is None
    assert as_network(Transport(0.0, 0.0)) is None
    lossy = Transport(0.0, 0.0, drop_rate=0.01)
    assert as_network(lossy) is lossy
    for kw, name in ((dict(drop_rate=1.0), "drop_rate"),
                     (dict(dup_rate=-0.1), "dup_rate"),
                     (dict(ack_timeout=0.0), "ack_timeout"),
                     (dict(max_retries=-1), "max_retries"),
                     (dict(backoff=0.5), "backoff")):
        with pytest.raises(ValueError, match=name):
            Transport(0.0, 0.0, **kw)
    tr = Transport(0.0, 0.0, drop_rate=0.1, ack_timeout=0.3)
    for k in range(7):
        assert tr.timeout(k) == pytest.approx(0.3 * min(2.0 ** k, 8.0))
    assert tr.timeout(3) == tr.timeout(50)


def test_exactly_once_fold_and_fallback():
    _, port = pairs.sessions("random")
    tr = Transport(0.0, 0.0, drop_rate=0.3, dup_rate=0.2, reorder_rate=0.3,
                   ack_timeout=0.5, max_retries=2)
    rt = PSRuntime(port.spec, data=port.data, timing=CostProfile(
        t_worker=ConstantService(1.0), t_server_block=ConstantService(0.25),
        net=tr))
    res = rt.run(ROUNDS)
    folds = [f for dom in rt.domains for f in dom.fold_log]
    assert len(folds) == len(set(folds)) == res.metrics["pushes"]
    assert res.metrics["transport"]["dups_dropped"] > 0
    heavy = port.run_ps(ROUNDS, transport=Transport(
        0.0, 0.0, drop_rate=0.45, ack_timeout=0.4, max_retries=0))
    assert heavy.metrics["transport"]["timeout_fallbacks"] > 0
    assert heavy.metrics["max_served_tau"] <= heavy.metrics["bound"]


def test_link_loss_validation():
    with pytest.raises(ValueError, match="duration"):
        FaultPlan.of(FaultPlan.link_loss(1.0, 0.0, 0.5))
    with pytest.raises(ValueError, match="drop probability"):
        FaultPlan.of(FaultPlan.link_loss(1.0, 2.0, 1.5))
    plan = FaultPlan.of(FaultPlan.link_loss(1.0, 2.0, 0.5, block=2))
    assert FaultPlan.from_json(plan.to_json()).has_link_loss


# ---------------------------------------------------------------------------
# divergence watchdog (the committed-block check runs on tensors)
# ---------------------------------------------------------------------------

def test_runtime_divergence_watchdog():
    # rho ~ 1e-38: the first worker update overflows fp32, so the first
    # committed z is non-finite
    from repro_torch.api import ConsensusSession
    from repro_torch.configs.base import ADMMConfig
    cfg = ADMMConfig(rho=1e-38, gamma=1e-30, max_delay=2, block_fraction=1.0,
                     num_blocks=M, block_selection="random", seed=0)
    sess = ConsensusSession.flat(
        lambda z, c: 0.5 * torch.sum(torch.square(z - c)),
        torch.as_tensor(pairs.CENTERS), dim=pairs.DIM, cfg=cfg,
        edge=pairs.EDGE, rho_scale=pairs.RHO_SCALE, device="cpu")
    with pytest.raises(FloatingPointError, match="block"):
        sess.run_ps(ROUNDS, check_finite=True)
    res = sess.run_ps(ROUNDS)
    assert not bool(torch.isfinite(res.z_final).all())
    _, healthy = pairs.sessions("random")
    ok = healthy.run_ps(ROUNDS, check_finite=True)
    assert bool(torch.isfinite(ok.z_final).all())


# ---------------------------------------------------------------------------
# trace files: the transport log round-trips; bad files fail clearly
# ---------------------------------------------------------------------------

def test_trace_transport_log_roundtrip(tmp_path):
    _, port = pairs.sessions("random")
    res = port.run_ps(ROUNDS, transport=_lossy(tps))
    back = DelayTrace.load(res.trace.save(str(tmp_path / "lossy")))
    assert back.transport == res.trace.transport
    assert back.meta["transport"]["drop_rate"] == 0.1
    np.testing.assert_array_equal(back.delays, res.trace.delays)
    # the reference reads the port's file the same way
    assert rps.DelayTrace.load(str(tmp_path / "lossy.npz")).transport == \
        res.trace.transport


@pytest.mark.parametrize("case", ["missing_key", "extra_key", "shape",
                                  "participation", "json", "not_npz",
                                  "truncated"])
def test_trace_load_errors(tmp_path, case):
    path = tmp_path / f"{case}.npz"
    base = dict(delays=np.zeros((2, N, M), np.int32), bound=np.int32(2),
                discipline=np.str_("lockfree"))
    match = case
    if case == "missing_key":
        np.savez(path, delays=base["delays"])
        match = "bound"
    elif case == "extra_key":
        np.savez(path, **base, bogus=np.zeros(3))
        match = "bogus"
    elif case == "shape":
        np.savez(path, **{**base, "delays": np.zeros((2, N), np.int32)})
        match = r"\(rounds, N, M\)"
    elif case == "participation":
        np.savez(path, **base, participation=np.ones((5, N), bool))
    elif case == "json":
        np.savez(path, **base, meta=np.str_("{not json"))
        match = "corrupt"
    elif case == "not_npz":
        path.write_bytes(b"this is not a zip archive")
    else:
        np.savez(path, **base)
        data = path.read_bytes()
        path.write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match=match if case not in (
            "not_npz", "truncated") else path.name):
        DelayTrace.load(str(path))
    with pytest.raises(FileNotFoundError):
        DelayTrace.load(str(tmp_path / "absent.npz"))


def test_old_trace_without_new_keys_loads(tmp_path):
    path = tmp_path / "old.npz"
    np.savez(path, delays=np.zeros((2, N, M), np.int32), bound=np.int32(2),
             discipline=np.str_("lockfree"))
    tr = DelayTrace.load(str(path))
    assert tr.meta == {} and tr.events == [] and tr.transport == []
    assert tr.participation is None
