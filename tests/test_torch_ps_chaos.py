"""The port's elastic PS runtime (``repro_torch.ps.chaos`` /
``membership``) against the reference's ``tests/test_ps_chaos.py``.

A chaos plan with every worker-side event kind (crash + rejoin, a cold
join, a slowdown, a server spike) and the churn plan of the speedup
benchmark take the reference's schedule exactly — makespan, staleness,
participation, the event timeline, metrics — and the reference's z
within its backend tolerance; the port's chaos traces replay through
its epoch and round-trip through the ``.npz`` format into the
reference's loader; ``FaultPlan``, ``FaultInjector``,
``MembershipManager`` and ``DelayTrace.set_participation`` behave as
in the reference. Random selections come from the reference's engine
(``test_torch_ps_pairs.inject_selection``).
"""
import numpy as np
import pytest

import test_torch_ps_pairs as pairs
from repro import ps as rps
from repro_torch import ps as tps
from repro_torch.benchmarks import speedup
from repro_torch.ps import (DelayTrace, FaultEvent, FaultInjector, FaultPlan,
                            MembershipManager, as_service)

ROUNDS = 10
N8, M8 = 4, 8
CENTERS = np.random.RandomState(11).randn(N8, M8 * 5).astype(np.float32)


def _plan(ps):
    """crash+rejoin, a cold join, a straggler and a hot server."""
    return ps.FaultPlan.of(ps.FaultPlan.crash(1, 3.5, 3.0),
                           ps.FaultPlan.join(3, 2.5),
                           ps.FaultPlan.slowdown(0, 1.0, 4.0, 3.0),
                           ps.FaultPlan.server_spike(2, 2.0, 5.0, 4.0))


def _churn(ps):
    return ps.FaultPlan.churn(N8, seed=0, crashes=2, window=(2.0, 8.0),
                              down=(2.0, 5.0))


@pytest.mark.parametrize("plan,discipline", [(_plan, "lockfree"),
                                             (_plan, "per_push"),
                                             (_churn, "per_push")],
                         ids=["plan-lockfree", "plan-per_push",
                              "churn-per_push"])
def test_chaos_run_matches_reference(monkeypatch, plan, discipline):
    ref, port = pairs.sessions("random", edge=None, centers=CENTERS,
                               num_blocks=M8)
    pairs.inject_selection(monkeypatch, ref)
    rt, tt = pairs.timings("constant")
    r = ref.run_ps(ROUNDS, discipline=discipline, timing=rt,
                   faults=plan(rps))
    t = port.run_ps(ROUNDS, discipline=discipline, timing=tt,
                    faults=plan(tps))
    pairs.assert_same_schedule(r, t)
    pairs.assert_same_z(r, t)
    assert t.trace.participation is not None
    assert t.metrics["crashes"] >= 1
    assert t.metrics["version_resets"] == t.metrics["rejoins"]


def test_tree_chaos_run_matches_reference_and_replays(monkeypatch):
    """A pytree session under the chaos plan, per-push discipline
    (tests/test_ps_chaos.py:102)."""
    ref, port = pairs.sessions("random", edge=None, centers=CENTERS,
                               num_blocks=M8, tree=True)
    pairs.inject_selection(monkeypatch, ref)
    (rb, tb), (rt, tt) = pairs.batches(CENTERS), pairs.timings("constant")
    r = ref.run_ps(ROUNDS, discipline="per_push", timing=rt,
                   faults=_plan(rps), batches=rb)
    t = port.run_ps(ROUNDS, discipline="per_push", timing=tt,
                    faults=_plan(tps), batches=tb)
    pairs.assert_same_schedule(r, t)
    pairs.assert_same_z(r, t)
    assert t.metrics["crashes"] >= 1
    monkeypatch.undo()
    own = port.run_ps(ROUNDS, discipline="per_push", timing=tt,
                      faults=_plan(tps), batches=tb)
    _, replay = pairs.sessions("random", edge=None, centers=CENTERS,
                               num_blocks=M8, tree=True,
                               delay_models=(None, own.to_delay_model()))
    pairs.assert_replays(own, replay, batch=tb(0))


def test_chaos_trace_replays_and_roundtrips(tmp_path):
    _, port = pairs.sessions("random", edge=None, centers=CENTERS,
                             num_blocks=M8)
    res = port.run_ps(ROUNDS, timing=pairs.timings("constant")[1],
                      faults=_plan(tps))
    path = res.trace.save(str(tmp_path / "chaos_trace"))
    for loader in (DelayTrace.load, rps.DelayTrace.load):
        loaded = loader(path)
        np.testing.assert_array_equal(loaded.delays, res.trace.delays)
        np.testing.assert_array_equal(loaded.participation,
                                      res.trace.participation)
        assert loaded.events == res.trace.events
        assert loaded.meta["crashes"] == res.metrics["crashes"]
    _, replay = pairs.sessions(
        "random", edge=None, centers=CENTERS, num_blocks=M8,
        delay_models=(None, DelayTrace.load(path).to_delay_model()))
    pairs.assert_replays(res, replay)
    # a plan saved as JSON drives the same run
    again = port.run_ps(ROUNDS, timing=pairs.timings("constant")[1],
                        faults=_plan(tps).save(str(tmp_path / "plan.json")))
    assert again.makespan == res.makespan
    np.testing.assert_array_equal(again.trace.delays, res.trace.delays)


def test_leave_and_ineffective_rejoin():
    _, port = pairs.sessions("random", edge=None, centers=CENTERS,
                             num_blocks=M8)
    timing = pairs.timings("constant")[1]
    res = port.run_ps(ROUNDS, timing=timing,
                      faults=FaultPlan.of(FaultPlan.leave(2, 4.0)))
    gone = np.nonzero(~res.trace.participation[:, 2])[0]
    assert gone.size > 0 and list(gone) == list(range(gone[0], ROUNDS))
    assert res.metrics["rejoins"] == 0 and np.isfinite(res.losses).all()
    late = port.run_ps(ROUNDS, timing=timing,
                       faults=FaultPlan.of(FaultPlan.crash(1, 2.0, 1000.0)))
    ev = [e for e in late.trace.events if e["kind"] == "rejoin"]
    assert ev and ev[0].get("effective") is False
    assert not late.trace.participation[-1, 1]


def test_churn_scenario_gates_on_cpu():
    lines = []
    assert speedup.churn_scenario(lines.append, smoke=True, device="cpu")
    assert any(ln.startswith("churn_replay_err_1dev,0.00e+00")
               for ln in lines)


# ---------------------------------------------------------------------------
# membership, fault plans, the injector (the port's copies)
# ---------------------------------------------------------------------------

def test_membership_intervals_and_queries():
    mm = MembershipManager(3, 10, cold=(2,))
    assert mm.is_active(0) and not mm.is_active(2)
    mm.deactivate(0, 4)
    mm.activate(0, 7)
    assert mm.required(0, 3) and not mm.required(0, 5) and mm.required(0, 8)
    mm.activate(2, 6)
    assert not mm.required(2, 5) and mm.required(2, 6)
    P = mm.participation_matrix()
    assert P.shape == (10, 3) and P[:, 1].all()
    assert list(np.nonzero(~P[:, 0])[0]) == [4, 5, 6]
    assert mm.participated_rounds(0) == 7 and mm.participated_rounds(2) == 4
    assert mm.crashes == 1 and mm.rejoins == 2 and mm.elastic
    mm.deactivate(0, 8)
    with pytest.raises(RuntimeError):
        mm.deactivate(0, 9)
    m2 = MembershipManager(1, 10)
    m2.deactivate(0, 4)
    with pytest.raises(RuntimeError):
        m2.activate(0, 2)
    with pytest.raises(ValueError):
        MembershipManager(2, 10, cold=(5,))
    m3 = MembershipManager(2, 10)
    m3.deactivate(0, 3)
    m3.activate(0, 3)
    assert m3.participation_matrix()[:, 0].all()


def test_injector_factor_windows():
    plan = FaultPlan.of(FaultPlan.slowdown(0, 1.0, 2.0, 3.0),
                        FaultPlan.slowdown(0, 2.0, 2.0, 2.0),
                        FaultPlan.server_spike(1, 1.0, 1.0, 4.0))
    inj = FaultInjector(plan, None)
    assert [inj.worker_factor(0, t) for t in (0.5, 1.5, 2.5, 3.5)] == \
        [1.0, 3.0, 6.0, 2.0]
    assert inj.worker_factor(1, 1.5) == 1.0
    assert inj.server_factor((1,), 1.5) == 4.0
    assert inj.server_factor((0, 1), 1.5) == 4.0
    assert inj.server_factor((0,), 1.5) == 1.0
    assert not inj.empty and FaultInjector(None, None).empty


def test_fault_plan_json_and_validation(tmp_path):
    plan = _plan(tps)
    assert FaultPlan.from_json(plan.to_json()) == plan
    assert FaultPlan.load(plan.save(str(tmp_path / "p.json"))) == plan
    assert FaultPlan(({"kind": "crash", "at": 1.0, "worker": 0},)) == \
        FaultPlan.of(FaultPlan.crash(0, 1.0))
    # the reference reads the port's plan file unchanged
    assert rps.FaultPlan.load(str(tmp_path / "p.json")).to_json() == \
        plan.to_json()
    for ev, match in ((FaultEvent("meteor", 1.0), "unknown fault kind"),
                      (FaultEvent("crash", -1.0, worker=0), "finite and >= 0"),
                      (FaultEvent("crash", 1.0), "needs a worker id"),
                      (FaultEvent("slowdown", 1.0, worker=0, factor=2.0),
                       "duration"),
                      (FaultEvent("crash", 1.0, worker=0, duration=-3.0),
                       "downtime")):
        with pytest.raises(ValueError, match=match):
            ev.validate()
    with pytest.raises(ValueError, match="outside"):
        FaultEvent("crash", 1.0, worker=9).validate(num_workers=4)
    with pytest.raises(ValueError, match="multiple join"):
        FaultPlan.of(FaultPlan.join(0, 1.0), FaultPlan.join(0, 2.0))
    a = FaultPlan.churn(8, seed=3, crashes=3)
    assert a == FaultPlan.churn(8, seed=3, crashes=3)
    assert a.to_json() == rps.FaultPlan.churn(8, seed=3, crashes=3).to_json()
    with pytest.raises(ValueError):
        FaultPlan.churn(2, crashes=3)


def test_set_participation_and_as_service():
    tr = DelayTrace.empty(3, 2, M8, bound=2)
    tr.delays[:] = 1
    with pytest.raises(ValueError, match="rounds, N"):
        tr.set_participation(np.ones((3, 5), bool))
    part = np.ones((3, 2), bool)
    part[1, 0] = False
    tr.set_participation(part)
    assert (tr.delays[1, 0] == -1).all() and tr.complete
    for bad in (-1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="finite and >= 0"):
            as_service(bad)
    assert as_service(0.0).sample(np.random.default_rng(0)) == 0.0
