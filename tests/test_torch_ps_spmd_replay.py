"""The PS runtime's churn, lossy and server_crash traces (the smoke runs
of ``repro_torch.benchmarks.speedup``) replayed through the SPMD epoch
on the reference's data 4 x model 2 mesh: one spawn of 8 gloo ranks on
the CPU (``benchmarks.spmd_replay.replay_spmd``) replays all three (and
then runs other work it is given on the same ranks), and every round's
z on every rank stays within 1e-5 of the runtime's, the reference's
tolerance for its own SPMD replay
(``tests/test_ps_runtime.py::test_spmd_trace_replay``). Measured on
the CPU: 2.98e-8 for each of the three (the worker sum's all-reduce
adds in another order than the single-device epoch)."""
from repro_torch.benchmarks import speedup
from repro_torch.benchmarks.spmd_replay import WORLD, replay_spmd, trace_job

TOL = 1e-5


def _after_the_replays(rank, mesh, k):
    """Other work the spawn carries (``extra``): an all-reduce in the
    ranks' process group, after the replays."""
    import torch
    import torch.distributed as dist
    t = torch.tensor([float(rank + k)])
    dist.all_reduce(t)
    return {"rank": rank, "coords": dict(mesh.coords), "sum": float(t)}


def test_three_traces_replay_on_eight_ranks():
    _, churn = speedup.churn_runs(smoke=True, device="cpu")
    _, lossy = speedup.lossy_runs(smoke=True, device="cpu")
    *_, crash = speedup.server_crash_runs(smoke=True, device="cpu")
    runs = {"churn": churn, "lossy": lossy, "server_crash": crash}
    assert churn.trace.participation is not None       # the crashed workers
    out, extras = replay_spmd({k: trace_job(r) for k, r in runs.items()},
                              speedup.REPLAY_SESSION, device="cpu",
                              extra=(_after_the_replays, (3,)))
    for name, res in runs.items():
        assert out[name]["rounds"] == res.num_rounds == 16
        assert len(out[name]["launches_per_rank"]) == WORLD
        assert out[name]["err"] <= TOL, (name, out[name]["err"])
    # the same ranks then ran the extra work, in one process group
    assert [e["rank"] for e in extras] == list(range(WORLD))
    assert all(e["sum"] == sum(range(WORLD)) + 3 * WORLD for e in extras)
    assert len({tuple(sorted(e["coords"].items())) for e in extras}) == WORLD


def test_scenarios_defer_their_replays_to_one_spawn(monkeypatch):
    """Given a ``replays`` dict, churn, lossy and server_crash spawn
    nothing: each puts its trace's job there, and ``spmd_replays``
    hands all three to one ``replay_spmd`` call and emits each job's
    lines."""
    calls = []

    def fake_replay(jobs, session_kw, device="cpu"):
        calls.append(sorted(jobs))
        return {name: {"err": 0.0, "rounds": job["z"].shape[0] - 1,
                       "launches_per_rank": [{}] * WORLD,
                       "spawn_seconds": 1.0}
                for name, job in jobs.items()}

    monkeypatch.setattr(speedup, "replay_spmd", fake_replay)
    lines, replays = [], {}
    for name in ("churn", "lossy", "server_crash"):
        assert speedup.SCENARIOS[name](lines.append, smoke=True,
                                       device="cpu", replays=replays)
    assert calls == [] and sorted(replays) == ["churn", "lossy",
                                               "server_crash"]
    errs = speedup.spmd_replays(lines.append, replays, device="cpu")
    assert calls == [["churn", "lossy", "server_crash"]]
    assert errs == {"churn": 0.0, "lossy": 0.0, "server_crash": 0.0}
    for name in replays:
        assert f"{name}_replay_err_spmd,0.00e+00,mesh=data4xmodel2" in lines
        assert f"{name}_replay_spmd_launches,16,spawn_s=1.0" in lines
