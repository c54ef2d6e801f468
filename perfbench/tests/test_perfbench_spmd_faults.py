"""``spmd_solve`` on the CPU with a fault planted in one or every rank's
process (``spmd_faults.py``): four gloo ranks at a tiny flat size read
``correct`` false, a rank that dies ends the run at once, and a rank
that loads JAX fails the run."""
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from perfbench.drivers import spmd_solve
from perfbench.harness import manifest
from spmd_faults import run_four

HERE = Path(__file__).resolve().parent


@pytest.fixture(autouse=True)
def restore_plants(monkeypatch):
    """Rank 0 runs in this process: what a plant replaces in it is put
    back after each test."""
    from perfbench.tests import spmd_faults
    for owner, name in spmd_faults.targets():
        monkeypatch.setattr(owner, name, getattr(owner, name))


@pytest.mark.parametrize("plant", ["unchanged_state", "half_batch",
                                   "drop_partial_w", "no_exchange",
                                   "other_seed", "altered_ring"])
def test_planted_faults_are_not_correct(plant):
    line, _ = run_four(plant)
    assert line["correct"] is False, (plant, line["checked"])


def test_a_rank_that_dies_ends_the_run_at_once():
    """Rank 3 exits after its warm-up: rank 0's run fails, naming it,
    with no result and well inside the group's timeout (by the watch on
    the ranks, ``RANK_DIED``, or by a collective that finds the rank
    gone), and leaves no rank behind."""
    t0 = time.monotonic()
    proc = _run_alone("exit_after_warmup")
    assert time.monotonic() - t0 < spmd_solve.GROUP_TIMEOUT_S / 2
    assert proc.returncode != 0, proc.stderr[-2000:]
    assert "rank 3 exited with code 3" in proc.stderr
    assert "correct" not in proc.stdout
    _no_rank_left("exit_after_warmup")


def test_a_rank_that_loads_jax_fails_the_run():
    """Rank 2 has a module ``jax`` loaded when it is done: it names it and
    exits with ``FORBIDDEN_LOADED``, and rank 0's run fails with no
    result and no rank left."""
    proc = _run_alone("loads_jax")
    assert proc.returncode != 0, proc.stderr[-2000:]
    assert "rank 2 refused: modules ['jax'] were loaded" in proc.stderr
    assert (f"rank 2 exited with code {spmd_solve.FORBIDDEN_LOADED}"
            in proc.stderr or
            f"exited with [0, {spmd_solve.FORBIDDEN_LOADED}, 0]"
            in proc.stderr), proc.stderr[-2000:]
    assert "correct" not in proc.stdout
    _no_rank_left("loads_jax")


def _run_alone(plant: str) -> subprocess.CompletedProcess:
    """A four-rank run with ``plant`` in a process of its own (rank 0's
    way out may be ``os._exit``)."""
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(HERE)!r}, {str(manifest.ROOT)!r},
                        {str(manifest.ROOT / 'src')!r}]
        from spmd_faults import run_four
        print(run_four({plant!r}))
    """)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=spmd_solve.GROUP_TIMEOUT_S)


def _no_rank_left(plant: str):
    deadline = time.monotonic() + 5.0
    while True:
        left = [p for p in Path("/proc").glob("[0-9]*")
                if plant.encode() in _cmdline(p)]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.1)
    assert not left, [(p.name, _cmdline(p)[:300]) for p in left]


def _cmdline(proc: Path) -> bytes:
    try:
        return (proc / "cmdline").read_bytes()
    except OSError:              # gone meanwhile
        return b""
