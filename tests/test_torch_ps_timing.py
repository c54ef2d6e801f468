"""The port's PS runtime in timing-only mode against the reference's:
(a) of ``test_torch_ps_runtime.py``, in a file of its own to keep each
file short. The same makespans (``==``), trace delays, histograms and
metrics, for lockfree / locked / per_push under constant, lognormal,
Pareto and network-latency cost profiles, with cyclic selection over a
full edge set (no draws) and with random selection served from the
reference's engine (``test_torch_ps_pairs.inject_selection``); and the zipf
selector, which draws only from (seed, t), runs timing-only.
"""
import pytest

import test_torch_ps_pairs as pairs
from repro import ps as rps
from repro_torch import ps as tps
from repro_torch.benchmarks import speedup


# ---------------------------------------------------------------------------
# (a) timing-only runs: the schedule is the reference's, exactly
# ---------------------------------------------------------------------------

def _timing_runs(ref, port, discipline, kind, rounds=10):
    rt, tt = pairs.timings(kind)
    r = rps.PSRuntime(ref.spec, discipline=discipline, timing=rt,
                      compute="timing").run(rounds)
    t = tps.PSRuntime(port.spec, discipline=discipline, timing=tt,
                      compute="timing").run(rounds)
    assert t.z_versions is None and t.z_final is None and t.losses is None
    return r, t


@pytest.mark.parametrize("kind", ["constant", "lognormal", "pareto", "net"])
@pytest.mark.parametrize("discipline", ["lockfree", "locked"])
def test_timing_only_matches_reference_cyclic(discipline, kind):
    ref, port = pairs.sessions("cyclic", edge=None)
    pairs.assert_same_schedule(*_timing_runs(ref, port, discipline, kind))


@pytest.mark.parametrize("discipline", ["lockfree", "locked", "per_push"])
def test_timing_only_matches_reference_random(monkeypatch, discipline):
    ref, port = pairs.sessions("random")
    pairs.inject_selection(monkeypatch, ref)
    pairs.assert_same_schedule(*_timing_runs(ref, port, discipline,
                                             "pareto"))


def test_zipf_selector_runs_timing_only():
    """zipf draws only from (seed, t): it is gradient-free, so the
    runtime takes it in timing-only mode (the skew scenario does)."""
    _, port = pairs.sessions("zipf")
    assert port.spec.selector.gradient_free
    res = tps.PSRuntime(port.spec, compute="timing").run(4)
    assert res.trace.complete
    assert speedup.skew_scenario(lambda line: None, smoke=True,
                                 device="cpu")
