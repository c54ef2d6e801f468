"""The port's PS runtime (``repro_torch.ps``) against the reference's
(``repro.ps``), on the CPU.

(a) timing-only runs, in ``test_torch_ps_timing.py``;
(b) real compute: z at every version within rtol 1e-5 / atol 1e-6 of
    the reference's ``run_ps`` (``tests/test_ps_runtime.py:97``) for
    cyclic, Gauss-Southwell and injected random selection, and for
    minibatch runs;
(c) the port's own trace replays through the port's epoch;
(d) trace files interchange: a trace saved by either package loads
    through the other's ``TraceDelay.load`` and replays to the run's z;
(e) a committed version never changes after later rounds (torch
    tensors are mutable where the reference's arrays were not);
(f) the durability features not yet ported raise, naming the ROADMAP
    item.

Random selections and minibatches come from the reference's engine
(``test_torch_ps_pairs.inject_*``); the rest of each run is numpy on both
sides.
"""
import numpy as np
import pytest
import torch

import test_torch_ps_pairs as pairs
from repro.core import space as rspace
from repro_torch import ps as tps
from repro_torch.benchmarks import speedup
from repro_torch.core import space as tspace

ROUNDS = pairs.ROUNDS


# ---------------------------------------------------------------------------
# (b) real compute: z as the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("discipline", ["lockfree", "locked"])
@pytest.mark.parametrize("selection", ["cyclic", "gauss_southwell",
                                       "random"])
def test_real_compute_matches_reference(monkeypatch, selection, discipline):
    ref, port = pairs.sessions(selection,
                               edge=None if selection == "cyclic"
                               else pairs.EDGE)
    if selection == "random":
        pairs.inject_selection(monkeypatch, ref)
    rt, tt = pairs.timings("pareto")
    r = ref.run_ps(ROUNDS, discipline=discipline, timing=rt)
    t = port.run_ps(ROUNDS, discipline=discipline, timing=tt)
    pairs.assert_same_schedule(r, t)
    pairs.assert_same_z(r, t)
    assert t.z_final.shape == (pairs.DIM,)
    assert torch.equal(t.z_final, t.z_versions[-1])


def test_minibatch_matches_reference(monkeypatch):
    ref, port = pairs.sessions("random", logreg=True, edge=None,
                               minibatch=0.5)
    pairs.inject_selection(monkeypatch, ref)
    pairs.inject_minibatch(monkeypatch, ref)
    rt, tt = pairs.timings("lognormal")
    r = ref.run_ps(ROUNDS, timing=rt)
    t = port.run_ps(ROUNDS, timing=tt)
    pairs.assert_same_schedule(r, t)
    pairs.assert_same_z(r, t)


# ---------------------------------------------------------------------------
# (c) the port's own runtime replays through the port's epoch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(selection="random", discipline="lockfree"),
    dict(selection="random", discipline="locked"),
    dict(selection="gauss_southwell", discipline="lockfree"),
    dict(selection="random", discipline="per_push", logreg=True,
         minibatch=0.5, edge=None)], ids=lambda c: "-".join(
             str(v) for v in c.values()))
def test_port_trace_replays_through_port_epoch(case):
    case = dict(case)
    disc = case.pop("discipline")
    _, port = pairs.sessions(**case)
    res = port.run_ps(ROUNDS, discipline=disc,
                      timing=pairs.timings("pareto")[1])
    assert res.trace.complete and res.trace.delays.max() <= 2
    _, replay = pairs.sessions(
        **case, delay_models=(None, res.to_delay_model()))
    pairs.assert_replays(res, replay)
    # the runtime's per-round mean loss is the epoch's under replay
    state = replay.init()
    for t in range(ROUNDS):
        state, info = replay.step(state)
        np.testing.assert_allclose(res.losses[t], float(info["loss"]),
                                   rtol=1e-5)


def test_engine_draws_are_the_epochs():
    """The engine's round-t selection and minibatch are the epoch's
    generators' (seed, t, stream) draws, so replay needs no chain."""
    _, port = pairs.sessions("random", logreg=True, edge=None, minibatch=0.5)
    eng = tps.SpaceEngine(port.spec)
    from repro_torch.device import seeded_generator
    spec = port.spec
    for t in (0, 3):
        ctx = tspace.SelectorContext(
            rng=seeded_generator(spec.device, spec.seed, t, tspace._SELECT),
            edge=spec.edge, t=t, block_fraction=spec.block_fraction,
            grad_sqnorm=None)
        want = spec.selector(ctx).numpy()
        got = np.stack([eng.select(t, i, None) for i in range(pairs.N)])
        assert got.dtype == bool
        np.testing.assert_array_equal(got, want)
    a = eng.round_data(2, port.data)
    b = eng.round_data(2, port.data)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (pairs.N, 12, pairs.DIM)


# ---------------------------------------------------------------------------
# (d) trace files interchange between the packages
# ---------------------------------------------------------------------------

def test_reference_trace_file_replays_in_the_port(tmp_path):
    ref, _ = pairs.sessions("gauss_southwell")
    r = ref.run_ps(ROUNDS, timing=pairs.timings("pareto")[0])
    path = r.trace.save(str(tmp_path / "ref_trace"))
    dm = tspace.TraceDelay.load(path)
    assert isinstance(dm, tspace.TraceDelay)
    np.testing.assert_array_equal(dm.delays, r.trace.delays)
    loaded = tps.DelayTrace.load(path)
    assert loaded.meta["makespan"] == r.makespan
    assert loaded.bound == r.trace.bound
    _, replay = pairs.sessions("gauss_southwell", delay_models=(None, dm))
    state = replay.init()
    for t in range(ROUNDS):
        state, _ = replay.step(state)
        np.testing.assert_allclose(replay.z(state).numpy(),
                                   np.asarray(r.z_versions[t + 1]),
                                   **pairs.TOL)


def test_port_trace_file_replays_in_the_reference(tmp_path):
    _, port = pairs.sessions("gauss_southwell")
    t_res = port.run_ps(ROUNDS, discipline="locked",
                        timing=pairs.timings("net")[1])
    path = t_res.trace.save(str(tmp_path / "port_trace"))
    dm = rspace.TraceDelay.load(path)
    np.testing.assert_array_equal(dm.delays, t_res.trace.delays)
    ref, _ = pairs.sessions("gauss_southwell", delay_models=(dm, None))
    state = ref.init()
    step = ref.step_fn()
    for t in range(ROUNDS):
        state, _ = step(state, ref.data)
        np.testing.assert_allclose(np.asarray(ref.z(state)),
                                   t_res.z_versions[t + 1].numpy(),
                                   **pairs.TOL)


# ---------------------------------------------------------------------------
# (e) committed versions are immutable
# ---------------------------------------------------------------------------

def test_committed_versions_never_change(monkeypatch):
    """Clone every block's content the moment it is committed; after the
    run every version still holds exactly that (no view of a store that
    a later round wrote into)."""
    _, port = pairs.sessions("random")
    at_commit = {}
    orig = tps.BlockServerProc._finish_commit

    def finish(self):
        v = self.version
        orig(self)
        for j in self.block_ids:
            at_commit[(j, v + 1)] = self.contents[j][v + 1].clone()

    monkeypatch.setattr(tps.BlockServerProc, "_finish_commit", finish)
    rt = tps.PSRuntime(port.spec, data=port.data,
                       timing=pairs.timings("pareto")[1])
    res = rt.run(ROUNDS)
    assert len(at_commit) == pairs.M * ROUNDS
    for (j, v), content in at_commit.items():
        assert torch.equal(rt.domain_of_block[j].content_at(j, v), content)
    for v in range(1, ROUNDS + 1):
        joined = torch.stack([at_commit[(j, v)] for j in range(pairs.M)])
        assert torch.equal(res.z_versions[v],
                           port.spec.space.to_user(joined))
    z1 = res.z_versions[1].clone()
    port.run_ps(ROUNDS)                       # a later run, same session
    assert torch.equal(res.z_versions[1], z1)


def test_engine_ops_return_new_tensors():
    _, port = pairs.sessions("random")
    eng = tps.SpaceEngine(port.spec)
    z0, y, w, x = eng.init(torch.arange(pairs.DIM, dtype=torch.float32))
    cache = eng.block_cache(w, 1)
    assert cache.is_contiguous() and cache.shape == (pairs.N, 128)
    assert cache.untyped_storage().data_ptr() != \
        w.untyped_storage().data_ptr()
    val = eng.push_value(w, 0, 1) + 7.0
    new = eng.apply_push(cache, 0, val)
    assert torch.equal(new[0], val) and not torch.equal(cache[0], val)
    assert torch.equal(cache, w[:, 1])
    before = [c.clone() for c in eng.split_blocks(z0)]
    zbuf = eng.z_tilde_buffer(2, eng.split_blocks(z0))
    assert torch.equal(zbuf[2], z0) and not zbuf[:2].any()
    _, g, _ = eng.grads(zbuf, port.data)
    y2, w2, x2 = eng.update(2, g, zbuf, y, w, x, np.ones(pairs.M, bool))
    assert torch.equal(y2[:2], y[:2]) and torch.equal(w2[:2], w[:2])
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 eng.split_blocks(z0)))


# ---------------------------------------------------------------------------
# (f) what is not ported yet raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(checkpoint_every=2),
                                dict(checkpoint_dir="snaps"),
                                dict(resume_from="snaps")])
def test_durability_arguments_raise(kw):
    _, port = pairs.sessions("cyclic", edge=None)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 1"):
        port.run_ps(ROUNDS, **kw)


def test_server_crash_raises():
    _, port = pairs.sessions("cyclic", edge=None)
    plan = tps.FaultPlan.of(tps.FaultPlan.server_crash(1, at=2.0, down=1.0))
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 1"):
        port.run_ps(ROUNDS, faults=plan)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 1"):
        speedup.SCENARIOS["server_crash"](print, smoke=True, device="cpu")


def test_runtime_rejects_bad_config():
    _, port = pairs.sessions("random")
    with pytest.raises(ValueError):
        tps.PSRuntime(port.spec, data=port.data, discipline="quantum")
    with pytest.raises(ValueError):
        tps.PSRuntime(port.spec, data=port.data, compute="psychic")
    with pytest.raises(ValueError):              # real mode needs data
        tps.PSRuntime(port.spec)
    _, gs = pairs.sessions("gauss_southwell")
    with pytest.raises(ValueError):              # GS needs gradients
        tps.PSRuntime(gs.spec, compute="timing")
    with pytest.raises(ValueError):
        tps.PSRuntime(port.spec, data=port.data).run(0)


def test_run_ps_defaults_to_the_card():
    """Built without ``device=``, a session (and so its runtime) asks
    for the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import api as tapi
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.ConsensusSession.flat(lambda z, c: torch.sum(z), torch.zeros(
            pairs.N, pairs.DIM), dim=pairs.DIM)
