"""The port's durability layer (``repro_torch.ps.recovery``, the WAL hooks
in ``ps/server.py`` and the snapshot knobs of ``PSRuntime.run``) against
the reference's, on the CPU.

(a) a ``server_crash`` run takes the reference's schedule exactly —
    fold logs, trace events, delays, ``server_recoveries``, ``wal``,
    makespan — and the reference's z within TOL (``CRASH_PLAN`` of
    ``tests/test_ps_recovery.py:46``);
(b) snapshots interchange: one written by the reference resumes in the
    port, one written by the port resumes in the reference, and each
    finishes within TOL of the other package's uninterrupted run with
    delays, fold logs and makespan equal; for pytree sessions too;
(c) the rest of ``tests/test_ps_recovery.py``, port only: zero lost
    folds, bitwise z at bound 0, trace replay, determinism, timing-only
    runs, merged outages, the WAL's dedup and sequencing, resume parity
    at every snapshot, composition with worker chaos, inertness when
    off, the validation and fingerprint errors;
(d) resume determinism (``tests/test_resume_and_distributed.py:160-207``):
    the fixed schedule, and the hypothesis property where hypothesis is
    installed;
On the card, ``test_torch_kernels_cuda.py`` (which imports no JAX, so
it runs there) holds a crash run's replay through the epoch on the
kernels bitwise, with B2 launched once per block commit and once per
replayed block version.

Random selections in (a) and (b) come from the reference's engine
(``test_torch_ps_pairs.inject_selection``); (c) and (d) are port only and
draw the port's own.
"""
import json
import os

import numpy as np
import pytest
import torch

import test_torch_ps_pairs as pairs
from repro import ps as rps
from repro_torch import api as tapi
from repro_torch import ps as tps
from repro_torch.checkpoint import save
from repro_torch.configs.base import ADMMConfig
from repro_torch.ps import recovery as trec

ROUNDS = 8
TOL = pairs.TOL


def _crash_plan(ps):
    return ps.FaultPlan.of(ps.FaultPlan.server_crash(1, at=2.0, down=3.0))


def _timing(ps):
    return ps.CostProfile(t_worker=ps.ConstantService(1.0),
                          t_server_block=ps.ConstantService(0.25))


def _per_round_folds(rt):
    """{sid: {round: sorted [(worker, block)]}} from the fold logs."""
    out = {}
    for dom in rt.domains:
        rounds = {}
        for (v, i, j) in dom.fold_log:
            rounds.setdefault(v, []).append((i, j))
        out[dom.sid] = {v: sorted(fs) for v, fs in rounds.items()}
    return out


def _fold_logs(rt):
    return [[tuple(e) for e in d.fold_log] for d in rt.domains]


# ---------------------------------------------------------------------------
# (a) server_crash against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("discipline", ["lockfree", "locked", "per_push"])
def test_server_crash_matches_reference(monkeypatch, discipline):
    ref, port = pairs.sessions("random")
    pairs.inject_selection(monkeypatch, ref)
    rrt = rps.PSRuntime(ref.spec, data=ref.data, timing=_timing(rps),
                        discipline=discipline, faults=_crash_plan(rps))
    trt = tps.PSRuntime(port.spec, data=port.data, timing=_timing(tps),
                        discipline=discipline, faults=_crash_plan(tps))
    r, t = rrt.run(ROUNDS), trt.run(ROUNDS)
    pairs.assert_same_schedule(r, t)
    pairs.assert_same_z(r, t)
    assert _fold_logs(trt) == _fold_logs(rrt)
    assert t.metrics["server_recoveries"] == r.metrics["server_recoveries"] \
        == 1
    assert t.metrics["wal"] == r.metrics["wal"]
    assert [e["kind"] for e in t.trace.events] == ["server_crash",
                                                   "server_recover"]


# ---------------------------------------------------------------------------
# (b) snapshots interchange
# ---------------------------------------------------------------------------

def _snapshot_pair(monkeypatch, tmp_path, writer):
    """Both packages' runtimes on the same problem; the ``writer``
    package's uninterrupted run with ``checkpoint_every=2``."""
    ref, port = pairs.sessions("random")
    pairs.inject_selection(monkeypatch, ref)

    def runtime(ps, sess):
        return ps.PSRuntime(sess.spec, data=sess.data, timing=_timing(ps))
    rts = {"ref": lambda: runtime(rps, ref), "port": lambda: runtime(tps, port)}
    rt_full = rts[writer]()
    full = rt_full.run(ROUNDS, checkpoint_every=2,
                       checkpoint_dir=str(tmp_path / writer))
    return rts, rt_full, full


def _assert_cross_resume(rt_full, full, rt_res, res, full_is_port):
    np.testing.assert_array_equal(res.trace.delays, full.trace.delays)
    assert res.makespan == full.makespan
    assert _fold_logs(rt_res) == _fold_logs(rt_full)
    assert res.trace.events == full.trace.events
    a, b = (res, full) if full_is_port else (full, res)
    pairs.assert_same_z(a, b)         # reference first, the port second


@pytest.mark.parametrize("pick", [0, 1, 2])
def test_reference_snapshot_resumes_in_port(monkeypatch, tmp_path, pick):
    rts, rt_full, full = _snapshot_pair(monkeypatch, tmp_path, "ref")
    snaps = full.metrics["snapshots"]
    assert [os.path.basename(s) for s in snaps] == [
        "snap-000002", "snap-000004", "snap-000006"]
    rt_res = rts["port"]()
    res = rt_res.run(ROUNDS, resume_from=snaps[pick])
    _assert_cross_resume(rt_full, full, rt_res, res, full_is_port=False)
    assert res.metrics["snapshots"] == snaps[pick + 1:]


@pytest.mark.parametrize("pick", [0, 1, 2])
def test_port_snapshot_resumes_in_reference(monkeypatch, tmp_path, pick):
    rts, rt_full, full = _snapshot_pair(monkeypatch, tmp_path, "port")
    snaps = full.metrics["snapshots"]
    assert rps.list_snapshots(str(tmp_path / "port")) == snaps
    rt_res = rts["ref"]()
    res = rt_res.run(ROUNDS, resume_from=snaps[pick])
    _assert_cross_resume(rt_full, full, rt_res, res, full_is_port=True)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_tree_snapshot_resumes_in_the_other_package(monkeypatch, tmp_path,
                                                    writer):
    """A pytree session's snapshot, written by either package, resumes
    in the other and finishes as the writer's uninterrupted run."""
    ref, port = pairs.sessions("random", tree=True)
    pairs.inject_selection(monkeypatch, ref)
    rb, tb = pairs.batches()
    rts = {"ref": (lambda: rps.PSRuntime(ref.spec, batches=rb,
                                         timing=_timing(rps)), ref.z0),
           "port": (lambda: tps.PSRuntime(port.spec, batches=tb,
                                          timing=_timing(tps)), port.z0)}
    make, z0 = rts[writer]
    rt_full = make()
    full = rt_full.run(ROUNDS, z0=z0, checkpoint_every=2,
                       checkpoint_dir=str(tmp_path / writer))
    make, z0 = rts["port" if writer == "ref" else "ref"]
    rt_res = make()
    res = rt_res.run(ROUNDS, z0=z0, resume_from=full.metrics["snapshots"][1])
    assert isinstance(res.z_final, dict)
    _assert_cross_resume(rt_full, full, rt_res, res,
                         full_is_port=writer == "port")


def test_snapshot_files_match_reference(monkeypatch, tmp_path):
    """The same run's snapshot from either package: the same npz keys
    and shapes, the same manifest apart from the arrays' float bits
    (z within TOL) — fingerprint, clock, rng states, counters, fold
    logs, trace events."""
    ref, port = pairs.sessions("random")
    pairs.inject_selection(monkeypatch, ref)
    paths = {}
    for name, ps, sess in (("ref", rps, ref), ("port", tps, port)):
        rt = ps.PSRuntime(sess.spec, data=sess.data, timing=_timing(ps))
        res = rt.run(ROUNDS, checkpoint_every=3,
                     checkpoint_dir=str(tmp_path / name))
        paths[name] = res.metrics["snapshots"][0]
    r, t = rps.load_snapshot(paths["ref"]), tps.load_snapshot(paths["port"])
    assert set(t.arrays) == set(r.arrays)
    for k in r.arrays:
        assert t.arrays[k].dtype == r.arrays[k].dtype, k
        np.testing.assert_allclose(t.arrays[k], r.arrays[k], err_msg=k,
                                   **TOL)
    for k in ("format", "round", "clock", "fingerprint", "workers",
              "enforcer", "membership", "trace_events", "injector_fired"):
        assert t.meta[k] == r.meta[k], k
    for dr, dt in zip(r.meta["domains"], t.meta["domains"]):
        assert dt == dr
    np.testing.assert_allclose(t.meta["losses"][0], r.meta["losses"][0],
                               **TOL)


# ---------------------------------------------------------------------------
# (c) tests/test_ps_recovery.py, port only
# ---------------------------------------------------------------------------

def _cfg(**kw):
    return ADMMConfig(**pairs.cfg_kw("random", **kw))


def _session(cfg=None, delay_model=None, device="cpu"):
    return tapi.ConsensusSession.flat(
        lambda z, c: 0.5 * torch.sum(torch.square(z - c)),
        torch.as_tensor(pairs.CENTERS, device=device), dim=pairs.DIM,
        cfg=cfg or _cfg(), edge=pairs.EDGE, rho_scale=pairs.RHO_SCALE,
        delay_model=delay_model, device=device)


def _runtime(faults=None, cfg=None, **kw):
    sess = _session(cfg=cfg)
    return tps.PSRuntime(sess.spec, data=sess.data, timing=_timing(tps),
                         faults=faults, **kw)


def test_server_crash_zero_lost_folds():
    rt_ff = _runtime()
    ff = rt_ff.run(ROUNDS)
    rt_cr = _runtime(faults=_crash_plan(tps))
    cr = rt_cr.run(ROUNDS)
    assert _per_round_folds(rt_cr) == _per_round_folds(rt_ff)
    assert cr.metrics["server_recoveries"] == 1
    wal = cr.metrics["wal"]
    assert wal["replays"] == 1
    assert wal["commits"] == sum(d.version for d in rt_cr.domains)
    down, up = cr.trace.events
    assert (down["kind"], up["kind"]) == ("server_crash", "server_recover")
    assert up["time"] - down["time"] == pytest.approx(3.0)
    assert down["sid"] == up["sid"] == 1
    assert up["replayed"] == down["version"] >= 1
    assert cr.makespan > ff.makespan
    assert "server_recoveries" not in ff.metrics
    assert "wal" not in ff.metrics


def test_server_crash_bitwise_z_at_bound0():
    cfg = _cfg(max_delay=0)
    ff = _runtime(cfg=cfg).run(ROUNDS)
    cr = _runtime(cfg=cfg, faults=_crash_plan(tps)).run(ROUNDS)
    assert torch.equal(ff.z_final, cr.z_final)
    np.testing.assert_array_equal(ff.trace.delays, cr.trace.delays)


def test_server_crash_trace_replays():
    res = _session().run_ps(ROUNDS, timing=_timing(tps),
                            faults=_crash_plan(tps))
    pairs.assert_replays(res, _session(delay_model=res.to_delay_model()))


def test_server_crash_deterministic():
    a = _runtime(faults=_crash_plan(tps)).run(ROUNDS)
    b = _runtime(faults=_crash_plan(tps)).run(ROUNDS)
    assert torch.equal(a.z_final, b.z_final)
    np.testing.assert_array_equal(a.trace.delays, b.trace.delays)
    assert a.makespan == b.makespan


def test_server_crash_timing_only():
    sess = _session()
    rt = tps.PSRuntime(sess.spec, timing=_timing(tps), compute="timing",
                       faults=_crash_plan(tps))
    res = rt.run(ROUNDS)
    assert res.metrics["server_recoveries"] == 1
    assert res.trace.complete


def test_overlapping_server_crash_windows_merge():
    plan = tps.FaultPlan.of(tps.FaultPlan.server_crash(1, at=2.0, down=4.0),
                            tps.FaultPlan.server_crash(1, at=3.0, down=1.0))
    rt = _runtime(faults=plan)
    res = rt.run(ROUNDS)
    rt_ff = _runtime()
    rt_ff.run(ROUNDS)
    assert _per_round_folds(rt) == _per_round_folds(rt_ff)
    assert res.metrics["server_recoveries"] >= 1


def test_server_crash_dark_server_drops_messages():
    """A down domain answers nothing and commits nothing until its WAL
    replay; the replay restores the committed versions bitwise."""
    rt_cr = _runtime(faults=_crash_plan(tps))
    rt_cr.run(ROUNDS)
    dom = rt_cr.domains[1]
    before = {j: {v: c.clone() for v, c in dom.contents[j].items()}
              for j in dom.block_ids}
    dom.crash()
    assert dom.down and dom.version == 0 and dom.contents == {}
    sent = dom.dups_dropped
    dom.on_pull_request(0, 0)
    dom.on_declare_msg(0, ROUNDS - 1, [])
    dom._maybe_commit()
    assert dom.dups_dropped == sent and not dom._committing
    assert not dom._pull_state and not dom._decl
    dom.recover()
    assert dom.version == ROUNDS and not dom.down
    for j in dom.block_ids:
        for v, c in before[j].items():
            assert torch.equal(dom.contents[j][v], c), (j, v)


def test_wal_unit_dedup_and_sequencing():
    wal = tps.DomainWAL(0)
    assert wal.record_declare(0, 0, [(1, "v")]) is True
    assert wal.record_declare(0, 0, [(1, "v")]) is False
    assert wal.dedup_skips == 1
    wal.record_commit(0, [(0, 1)])
    with pytest.raises(RuntimeError, match="out of sequence"):
        wal.record_commit(2, [(0, 1)])
    assert wal.value(0, 0, 1) == "v"
    with pytest.raises(KeyError, match="no push"):
        wal.value(0, 0, 3)
    assert wal.pending(1) == []
    assert wal.pending(0) == [(0, 0, [(1, "v")])]
    assert wal.declares == 1


def _assert_same_run(a, b):
    assert torch.equal(a.z_final, b.z_final)
    assert all(torch.equal(x, y) for x, y in zip(a.z_versions, b.z_versions))
    np.testing.assert_array_equal(a.trace.delays, b.trace.delays)
    assert a.losses == b.losses
    assert a.makespan == b.makespan


def test_resume_parity_every_snapshot(tmp_path):
    rt_full = _runtime()
    full = rt_full.run(ROUNDS, checkpoint_every=2,
                       checkpoint_dir=str(tmp_path))
    snaps = full.metrics["snapshots"]
    assert [os.path.basename(s) for s in snaps] \
        == ["snap-000002", "snap-000004", "snap-000006"]
    assert tps.list_snapshots(str(tmp_path)) == snaps
    assert tps.latest_snapshot(str(tmp_path)) == snaps[-1]
    for snap in snaps:
        rt_res = _runtime()
        res = rt_res.run(ROUNDS, resume_from=snap)
        _assert_same_run(full, res)
        assert _fold_logs(rt_full) == _fold_logs(rt_res)
    for form in (str(tmp_path), snaps[-1] + ".json", snaps[-1] + ".npz"):
        _assert_same_run(full, _runtime().run(ROUNDS, resume_from=form))


def test_resume_composes_with_worker_chaos(tmp_path):
    plan = tps.FaultPlan.of(tps.FaultPlan.crash(1, 2.5, 2.0),
                            tps.FaultPlan.crash(2, 6.0, 1.0))
    full = _runtime(faults=plan).run(ROUNDS, checkpoint_every=2,
                                     checkpoint_dir=str(tmp_path))
    assert full.metrics["crashes"] == 2
    for snap in full.metrics["snapshots"]:
        res = _runtime(faults=plan).run(ROUNDS, resume_from=snap)
        _assert_same_run(full, res)
        np.testing.assert_array_equal(res.trace.participation,
                                      full.trace.participation)


def test_checkpoint_layer_inert_when_off():
    plain = _runtime().run(ROUNDS)
    again = _runtime().run(ROUNDS)
    _assert_same_run(plain, again)
    for key in ("snapshots", "wal", "server_recoveries"):
        assert key not in plain.metrics


def test_resume_validation_errors(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _runtime().run(ROUNDS, checkpoint_every=2)
    with pytest.raises(ValueError, match=">= 1"):
        _runtime().run(ROUNDS, checkpoint_every=0,
                       checkpoint_dir=str(tmp_path))
    with pytest.raises(FileNotFoundError):
        _runtime().run(ROUNDS, resume_from=str(tmp_path / "nope"))
    with pytest.raises(FileNotFoundError, match="nothing to resume"):
        _runtime().run(ROUNDS, resume_from=str(tmp_path))


def test_checkpoint_transport_incompatible(tmp_path):
    sess = _session()
    tr = tps.Transport(0.0, 0.0, drop_rate=0.1)
    rt = tps.PSRuntime(sess.spec, data=sess.data,
                       timing=tps.CostProfile(
                           t_worker=tps.ConstantService(1.0),
                           t_server_block=tps.ConstantService(0.25), net=tr))
    with pytest.raises(ValueError, match="transport"):
        rt.run(ROUNDS, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="transport"):     # WAL + snapshots
        _runtime(faults=_crash_plan(tps)).run(
            ROUNDS, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    rt2 = tps.PSRuntime(sess.spec, timing=_timing(tps), compute="timing")
    with pytest.raises(ValueError, match="timing"):
        rt2.run(ROUNDS, checkpoint_every=2, checkpoint_dir=str(tmp_path))


def test_resume_fingerprint_mismatch(tmp_path):
    full = _runtime().run(ROUNDS, checkpoint_every=2,
                          checkpoint_dir=str(tmp_path))
    snap = full.metrics["snapshots"][0]
    with pytest.raises(ValueError, match="num_rounds"):
        _runtime().run(ROUNDS + 2, resume_from=snap)
    with pytest.raises(ValueError, match="discipline"):
        _runtime(discipline="locked").run(ROUNDS, resume_from=snap)
    with pytest.raises(ValueError, match="cadence"):
        _runtime().run(ROUNDS, resume_from=snap, checkpoint_every=3)
    with pytest.raises(ValueError, match="seed"):
        _runtime(seed=5).run(ROUNDS, resume_from=snap)


def test_fingerprint_matches_reference(monkeypatch):
    """The run-shape identity a snapshot is checked against reads the
    same in both packages (``space`` is ``FlatSpace``)."""
    ref, port = pairs.sessions("random", minibatch=None)
    prints = []
    for ps, sess, rec in ((rps, ref, rps.recovery), (tps, port, trec)):
        rt = ps.PSRuntime(sess.spec, data=sess.data, timing=_timing(ps))
        rt.num_rounds, rt.ckpt = ROUNDS, None
        prints.append(rec._fingerprint(rt))
    assert prints[1] == prints[0]
    assert prints[1]["space"] == "FlatSpace"


def test_snapshot_format_validation(tmp_path):
    save(str(tmp_path / "notsnap"), {"z": np.zeros(3)}, step=1)
    with pytest.raises(ValueError, match="format"):
        tps.load_snapshot(str(tmp_path / "notsnap"))


def test_server_crash_event_validation():
    with pytest.raises(ValueError, match="block id"):
        tps.FaultPlan.of(tps.FaultPlan.server_crash(None, at=1.0, down=1.0))
    with pytest.raises(ValueError, match="duration"):
        tps.FaultPlan.of(tps.FaultPlan.server_crash(0, at=1.0, down=0.0))
    plan = tps.FaultPlan.of(tps.FaultPlan.server_crash(2, at=1.0, down=1.0))
    with pytest.raises(ValueError, match="outside"):
        plan.validate(num_workers=pairs.N, num_blocks=2)
    assert tps.FaultPlan.from_json(plan.to_json()).has_server_crash
    assert json.loads(plan.to_json())["events"][0]["kind"] == "server_crash"


# ---------------------------------------------------------------------------
# (d) resume determinism (tests/test_resume_and_distributed.py:160-207)
# ---------------------------------------------------------------------------

_PS_N, _PS_M, _PS_DBLK = 3, 4, 5
_PS_ROUNDS = 8


def _ps_runtime(faults):
    centers = np.random.RandomState(11).randn(
        _PS_N, _PS_M * _PS_DBLK).astype(np.float32)
    cfg = ADMMConfig(rho=2.0, gamma=0.1, max_delay=2, block_fraction=0.5,
                     num_blocks=_PS_M, block_selection="random",
                     l1_coef=1e-3, clip=0.8, seed=0)
    sess = tapi.ConsensusSession.flat(
        lambda z, c: 0.5 * torch.sum(torch.square(z - c)),
        torch.as_tensor(centers), dim=_PS_M * _PS_DBLK, cfg=cfg,
        device="cpu")
    return tps.PSRuntime(sess.spec, data=sess.data, timing=_timing(tps),
                         faults=faults)


def _resume_roundtrip(tmp_dir, every, crashes, pick):
    plan = tps.FaultPlan.of(*[tps.FaultPlan.crash(w, at, down)
                              for (w, at, down) in crashes]) \
        if crashes else None
    rt_full = _ps_runtime(plan)
    full = rt_full.run(_PS_ROUNDS, checkpoint_every=every,
                       checkpoint_dir=tmp_dir)
    snaps = full.metrics["snapshots"]
    assert snaps, "cadence <= rounds/2 must produce a snapshot"
    snap = snaps[pick % len(snaps)]
    rt_res = _ps_runtime(plan)
    res = rt_res.run(_PS_ROUNDS, resume_from=snap)
    return rt_full, full, rt_res, res, snap


def _assert_resume_identical(rt_full, full, rt_res, res, snap):
    assert _fold_logs(rt_full) == _fold_logs(rt_res), \
        f"fold log diverged after resume from {snap}"
    assert torch.equal(full.z_final, res.z_final), \
        f"final z diverged after resume from {snap}"
    np.testing.assert_array_equal(full.trace.delays, res.trace.delays)
    assert full.losses == res.losses
    assert full.makespan == res.makespan


def test_resume_determinism_fixed_schedule(tmp_path):
    _assert_resume_identical(
        *_resume_roundtrip(str(tmp_path), 2, [(1, 2.5, 1.5)], pick=1))


try:
    import tempfile

    from hypothesis import given, settings, strategies as st

    _crash_st = st.lists(
        st.tuples(st.integers(0, _PS_N - 1),          # worker
                  st.floats(0.5, 7.5),                # crash time
                  st.floats(0.5, 4.0)),               # downtime
        max_size=2,
        unique_by=lambda c: c[0])                     # one crash/worker

    @given(every=st.integers(1, _PS_ROUNDS // 2), crashes=_crash_st,
           pick=st.integers(0, 7))
    @settings(max_examples=10, deadline=None)
    def test_resume_determinism_property(every, crashes, pick):
        with tempfile.TemporaryDirectory() as td:
            _assert_resume_identical(
                *_resume_roundtrip(td, every, crashes, pick))
except ImportError:                                   # pragma: no cover
    pass
