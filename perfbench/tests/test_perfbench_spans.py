"""The step-span readers (``harness/spans.py``, ``metrics/*_device_ms``,
``traced_host_ms``, ``malloc_calls``) and ``tools/spans.py`` on a
hand-written Chrome trace: one
training step whose spans nest as the port records them, kernels, a
copy and a set charged through ``args.correlation``, the backward's
launches made from a second thread inside autograd's engine op, a
blocked ``cudaLaunchKernel``, a synchronise, and ``cudaMalloc`` inside
and outside the step.

The window's ``Summary`` is pinned to what ``trace.summarize`` gave
before the spans existed, so the accepted readers read as they did.
"""
import json
import os
from pathlib import Path

import pytest

from perfbench.harness import cell as cell_mod
from perfbench.harness import manifest, spans, trace
from perfbench.tools import spans as spans_tool

FIXTURE = Path(__file__).parent / "data" / "step_spans_trace.json"
US = 1e-6

# reader -> its value on the fixture (one step; device ms, host ms,
# calls)
EXPECTED = {
    "gather_device_ms": 0.020,            # the index kernel
    "codec_device_ms": 0.025,             # unpack's copy + pack's memcpy
    "forward_device_ms": 0.030,
    "backward_device_ms": 0.090,          # both launches of thread 2
    "select_device_ms": 0.005,
    "push_device_ms": 0.012,
    # the train step's 480 us less the blocked launch (60) and the
    # synchronise (20)
    "traced_host_ms": 0.400,
}


@pytest.fixture
def traces(tmp_path, monkeypatch):
    """The fixture as the one trace under a fresh ``out/``."""
    monkeypatch.setattr(manifest, "OUT_DIR", tmp_path)
    (tmp_path / "traces").mkdir()
    path = tmp_path / "traces" / "cell.json"
    path.write_text(FIXTURE.read_text())
    return path


def test_summary_is_what_it_was(traces):
    s = trace.summarize(traces, 1)
    assert s.window_s == pytest.approx(1000 * US)
    assert s.busy_s == pytest.approx(275 * US)
    assert s.steps == 1
    assert {k: (n, pytest.approx(sec)) for k, (n, sec) in s.kernels.items()} \
        == {"index_elementwise_kernel": (1, 20 * US),
            "direct_copy_kernel": (1, 10 * US),
            "elementwise_kernel": (2, 70 * US),
            "reduce_kernel": (1, 50 * US),
            "Memcpy DtoD (Device -> Device)": (1, 15 * US),
            "bernoulli_kernel": (1, 5 * US),
            "worker_select_update_kernel": (1, 60 * US),
            "server_prox_kernel": (1, 25 * US),
            "cat_kernel": (1, 12 * US),
            "Memset (Device)": (1, 8 * US)}
    assert [name for name, _ in s.device_ops] == [
        "elementwise_kernel", "worker_select_update_kernel",
        "reduce_kernel", "server_prox_kernel", "index_elementwise_kernel",
        "Memcpy DtoD (Device -> Device)", "cat_kernel",
        "direct_copy_kernel", "Memset (Device)", "bernoulli_kernel"]
    assert s.idle_gaps == pytest.approx([
        ("host: no recorded operation", 505 * US), ("aten::index", 100 * US),
        ("autograd::engine::evaluate_function: MulBackward0", 50 * US),
        ("cudaLaunchKernel", 25 * US), ("asybadmm.loss", 20 * US),
        ("asybadmm.epoch", 10 * US), ("asybadmm.select", 5 * US),
        ("asybadmm.push", 5 * US), ("cudaStreamSynchronize", 5 * US)])
    assert cell_mod.reader("other_device_ms.train")(s, {}, None) \
        == pytest.approx(1e3 * 190 * US)
    assert cell_mod.reader("device_idle_pct.train")(s, {}, None) \
        == pytest.approx(72.5)


@pytest.mark.parametrize("name", sorted(EXPECTED))
@pytest.mark.parametrize("suffix", ["solve", "train"])
def test_reader_on_the_fixture(traces, name, suffix):
    s = trace.summarize(traces, 1)
    got = cell_mod.reader(f"{name}.{suffix}")(s, {}, None)
    assert got == pytest.approx(EXPECTED[name])


def test_malloc_calls_count_only_the_train_step(traces):
    s = trace.summarize(traces, 1)
    assert cell_mod.reader("malloc_calls.train")(s, {}, None) == 1


def test_every_device_op_is_charged_once(traces):
    split = spans.split(traces, 1)
    assert split.device_s == pytest.approx({
        spans.GATHER: 20 * US, spans.UNPACK: 10 * US, spans.PACK: 15 * US,
        spans.FORWARD: 30 * US, spans.BACKWARD: 90 * US,
        spans.SELECT: 5 * US, spans.PUSH: 12 * US,
        spans.EPOCH: 85 * US,             # B1 and B2
        spans.NO_SPAN: 8 * US})           # the set launched after the step
    summary = trace.summarize(traces, 1)
    assert sum(split.device_s.values()) == pytest.approx(
        summary.kernel_seconds)


def test_the_tool_reports_the_split_and_the_launch_times(traces):
    """``tools/spans.py``: launches of 3, 4 ×5, 5 ×2 and the blocked
    60 us, by the histogram's edges; the six parts are all the device
    time outside B1 and B2 but the set launched after the step."""
    out = spans_tool.report(traces)
    assert out["steps"] == 1
    assert out["launch_us_hist"]["counts"] == [0, 6, 2, 0, 0, 1,
                                               0, 0, 0, 0, 0, 0]
    assert out["six_share_of_other"] == pytest.approx(182 / 190)
    assert out["traced_host_ms"] == pytest.approx(EXPECTED["traced_host_ms"])
    assert out["malloc_calls"] == 1


def test_the_reader_halves_over_two_steps(traces):
    s = trace.summarize(traces, 2)
    assert cell_mod.reader("push_device_ms.solve")(s, {}, None) \
        == pytest.approx(0.006)


def test_a_trace_without_step_spans_reads_nothing(traces):
    """The parent program records no step span: every new reader gives
    None and raises nothing."""
    with open(FIXTURE) as f:
        doc = json.load(f)
    doc["traceEvents"] = [e for e in doc["traceEvents"]
                          if e["name"] not in spans.STEP_SPANS]
    traces.write_text(json.dumps(doc))
    s = trace.summarize(traces, 1)
    for name in list(EXPECTED) + ["malloc_calls"]:
        suffixes = ["train"] if name == "malloc_calls" else ["solve",
                                                            "train"]
        for suffix in suffixes:
            assert cell_mod.reader(f"{name}.{suffix}")(s, {}, None) is None


def test_the_summarized_trace_is_found_among_newer_ones(traces):
    """A newer trace of another window is passed over for the one the
    summary was reduced from."""
    s = trace.summarize(traces, 1)
    with open(FIXTURE) as f:
        doc = json.load(f)
    doc["traceEvents"][0]["dur"] = 2000
    newer = traces.parent / "other.json"
    newer.write_text(json.dumps(doc))
    stat = traces.stat()
    os.utime(newer, (stat.st_atime + 10, stat.st_mtime + 10))
    assert spans.for_summary(s).spans[spans.TRAIN_STEP] == 1
    assert cell_mod.reader("traced_host_ms.train")(s, {}, None) \
        == pytest.approx(EXPECTED["traced_host_ms"])


def test_a_summary_without_its_trace_raises(traces):
    """A traced run whose trace is not under ``out/traces/`` is a fault
    of the harness, not a program without spans."""
    s = trace.summarize(traces, 1)
    traces.unlink()
    with pytest.raises(RuntimeError, match="summarized window"):
        spans.for_summary(s)


def test_the_names_are_the_programs(tmp_path):
    """The yardstick's copy of the span names is the port's registry."""
    from repro_torch.obs.names import STEP_SPANS
    assert set(spans.STEP_SPANS) == set(STEP_SPANS)
