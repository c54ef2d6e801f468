"""The port's step spans (``repro_torch.obs.step_span``).

Pins: with no profiler recording, a step never reaches
``record_function`` (nor its fast path); under ``torch.profiler`` a flat session step, a
tree trainer step and a Gauss-Seidel block round export every span their
path opens, nested as ``obs.names.STEP_SPANS`` declares; a profiled step
leaves the state bitwise the unprofiled one's; every name the program
passes to ``step_span`` is registered, every registered name is used,
and an unknown name raises.
"""
import ast
import json
from pathlib import Path

import pytest
import torch

from repro_torch.api import ConsensusSession
from repro_torch.configs.base import ADMMConfig
from repro_torch.obs import STEP_SPANS, step_span
from repro_torch.obs import step as step_mod
from repro_torch.training import ADMMTrainer

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
N = 3
WORKER_SPANS = {"asybadmm.gather", "asybadmm.unpack", "asybadmm.loss",
                "asybadmm.pack"}
# path -> the spans one step of it opens
OPENS = {
    "flat": set(STEP_SPANS) - {"admm.train_step"},
    "tree": set(STEP_SPANS),
    "block": {"admm.train_step", "asybadmm.epoch"} | WORKER_SPANS,
}


def _quad(z, c):
    return 0.5 * torch.sum(torch.square(z - c))


def _tree_loss(p, batch):
    pred = batch["x"] @ p["w"] + p["b"]
    return torch.mean(torch.square(pred - batch["y"]))


def _flat():
    """A flat session two steps in: (step(state) -> new state tables)."""
    gen = torch.Generator().manual_seed(3)
    sess = ConsensusSession.flat(
        _quad, torch.randn(N, 40, generator=gen), dim=40,
        cfg=ADMMConfig(rho=2.0, gamma=0.1, max_delay=1, block_fraction=0.5,
                       num_blocks=4, seed=5), device="cpu")
    state = sess.init()
    for _ in range(2):
        state, _ = sess.step(state)

    def step():
        new, _ = sess.step(state)
        return [new.z_hist, new.y, new.w_cache, new.x]
    return step


def _trainer(block: bool):
    """A tree trainer one step in; its step is ``train_step`` or, with
    ``block``, ``train_step_block`` of block 1."""
    gen = torch.Generator().manual_seed(4)
    params = {"w": torch.randn(6, 2, generator=gen),
              "b": torch.randn(2, generator=gen)}
    batch = {"x": torch.randn(N, 5, 6, generator=gen),
             "y": torch.randn(N, 5, 2, generator=gen)}
    tr = ADMMTrainer(loss_fn=_tree_loss, num_workers=N, device="cpu",
                     admm=ADMMConfig(rho=4.0, gamma=0.01, max_delay=1,
                                     block_fraction=0.5, num_blocks=2,
                                     seed=6))
    state = tr.init(params, cyclic=block)
    state, _ = (tr.train_step_block(state, batch, 0) if block
                else tr.train_step(state, batch))

    def step():
        new, _ = (tr.train_step_block(state, batch, 1) if block
                  else tr.train_step(state, batch))
        leaves = [new.z_hist, new.y] + ([] if block else [new.w_cache])
        return [v for tree in leaves for v in tree.values()]
    return step


MAKE = {"flat": _flat, "tree": lambda: _trainer(False),
        "block": lambda: _trainer(True)}


def _profiled(step, path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = step()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["tid"], e["name"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "cpu_op"
             and e["name"] in STEP_SPANS]
    return out, spans


@pytest.mark.parametrize("path", sorted(MAKE))
def test_off_path_never_reaches_record_function(path, monkeypatch):
    step = MAKE[path]()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function with no profiler recording")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(step_mod, "_RANGE", refuse)
    assert step()


@pytest.mark.parametrize("path", sorted(MAKE))
def test_profiled_step_exports_its_spans_nested(path, tmp_path):
    _, spans = _profiled(MAKE[path](), tmp_path / "trace.json")
    assert {name for *_, name in spans} == OPENS[path]
    for a, b, tid, name in spans:
        enclosing = [(a2, n2) for a2, b2, t2, n2 in spans
                     if t2 == tid and (a2, b2, n2) != (a, b, name)
                     and a2 <= a and b <= b2]
        parent = max(enclosing)[1] if enclosing else None
        want = STEP_SPANS[name][0]
        if path == "flat" and name == "asybadmm.epoch":
            want = None                 # a flat step's outermost span
        assert parent == want, (name, parent)


@pytest.mark.parametrize("path", sorted(MAKE))
def test_profiled_step_is_bitwise_the_unprofiled(path, tmp_path):
    step = MAKE[path]()
    plain = step()
    traced, _ = _profiled(step, tmp_path / "trace.json")
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _names_in_program():
    """Every first argument of a ``step_span`` call in the port."""
    found = []
    for path in sorted(SRC.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", None)) \
                    == "step_span":
                found.append((path.relative_to(SRC), node.args[0]))
    return found


def test_every_span_name_in_the_program_is_registered():
    found = _names_in_program()
    assert found
    for where, arg in found:
        assert isinstance(arg, ast.Constant), where
        assert arg.value in STEP_SPANS, (where, arg.value)
    assert {arg.value for _, arg in found} == set(STEP_SPANS)


def test_unknown_span_name_raises_while_recording():
    assert step_span("no.such.span") is step_span("asybadmm.epoch")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="unknown step span"):
            step_span("no.such.span")
        with step_span("asybadmm.epoch"):
            pass
