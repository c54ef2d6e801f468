"""The PS runtime's churn, lossy and server_crash traces (the smoke runs
of ``repro_torch.benchmarks.speedup``) replayed through the SPMD epoch
on the reference's data 4 x model 2 mesh: one spawn of 8 gloo ranks on
the CPU (``benchmarks.spmd_replay.replay_spmd``) replays all three, and
every round's z on every rank stays within 1e-5 of the runtime's, the
reference's tolerance for its own SPMD replay
(``tests/test_ps_runtime.py::test_spmd_trace_replay``). Measured on
the CPU: 2.98e-8 for each of the three (the worker sum's all-reduce
adds in another order than the single-device epoch)."""
from repro_torch.benchmarks import speedup
from repro_torch.benchmarks.spmd_replay import WORLD, replay_spmd, trace_job

TOL = 1e-5


def test_three_traces_replay_on_eight_ranks():
    _, churn = speedup.churn_runs(smoke=True, device="cpu")
    _, lossy = speedup.lossy_runs(smoke=True, device="cpu")
    *_, crash = speedup.server_crash_runs(smoke=True, device="cpu")
    runs = {"churn": churn, "lossy": lossy, "server_crash": crash}
    assert churn.trace.participation is not None       # the crashed workers
    out = replay_spmd({k: trace_job(r) for k, r in runs.items()},
                      speedup.REPLAY_SESSION, device="cpu")
    for name, res in runs.items():
        assert out[name]["rounds"] == res.num_rounds == 16
        assert len(out[name]["launches_per_rank"]) == WORLD
        assert out[name]["err"] <= TOL, (name, out[name]["err"])
