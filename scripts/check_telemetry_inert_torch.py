"""CI gate of the PyTorch port: telemetry must be inert and its exports
must validate (the port's analogue of ``check_telemetry_inert.py``).

Runs the same server-crash + worker-churn chaos scenario through
``repro_torch.ps.PSRuntime`` twice — once bare, once with FULL telemetry
(span tracer, JSONL sink, Chrome trace export, per-round stationarity)
— and fails unless:

* the final z is BITWISE identical across the two runs;
* makespan, the metrics dict (keys, order, values), the staleness trace
  and every lock domain's committed fold log are identical;
* every streamed JSONL record validates against
  ``repro_torch.obs.ROUND_RECORD_SCHEMA``;
* the exported Chrome trace is well-formed trace-event JSON whose span
  names all come from ``repro_torch.obs.SPAN_NAMES``.

    PYTHONPATH=src python scripts/check_telemetry_inert_torch.py [--device cuda]

Imports torch and the port only.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.api import ConsensusSession                 # noqa: E402
from repro_torch.configs.base import ADMMConfig              # noqa: E402
from repro_torch.obs import (SPAN_NAMES, Telemetry,          # noqa: E402
                             validate_record)
from repro_torch.ps import (CostProfile, FaultPlan,          # noqa: E402
                            LognormalService, ParetoService, PSRuntime)

N, M, DBLK = 8, 4, 5
DIM = M * DBLK
ROUNDS = 10

CHAOS = FaultPlan.of(FaultPlan.server_crash(1, at=2.0, down=3.0),
                     FaultPlan.crash(0, at=1.0, down=1.0))
STRAGGLER = CostProfile(t_worker=ParetoService(1.0, alpha=1.2),
                        t_server_block=LognormalService(0.3, 0.4))


def _loss(z, c):
    return 0.5 * torch.sum(torch.square(z - c))


def _runtime(device, telemetry=None):
    rng = np.random.RandomState(7)
    centers = torch.as_tensor(rng.randn(N, DIM).astype(np.float32))
    cfg = ADMMConfig(rho=2.0, gamma=0.1, max_delay=2, block_fraction=0.5,
                     num_blocks=M, block_selection="random", l1_coef=1e-3,
                     clip=0.8, seed=0)
    sess = ConsensusSession.flat(_loss, centers, dim=DIM, cfg=cfg,
                                 device=device)
    return PSRuntime(sess.spec, data=sess.data, timing=STRAGGLER,
                     faults=CHAOS, telemetry=telemetry)


def _fold_logs(rt):
    return {dom.sid: list(dom.fold_log) for dom in rt.domains}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)

    rt_off = _runtime(args.device)
    off = rt_off.run(ROUNDS)

    with tempfile.TemporaryDirectory(prefix="telemetry_gate_") as tmp:
        return _gate(args.device, off, rt_off, Path(tmp))


def _gate(device, off, rt_off, out: Path) -> int:
    jsonl = out / "rounds.jsonl"
    trace = out / "run.trace.json"
    tel = Telemetry(spans=True, sink=str(jsonl), trace_path=str(trace))
    rt_on = _runtime(device, telemetry=tel)
    on = rt_on.run(ROUNDS)

    # --- inertness -----------------------------------------------------
    assert on.makespan == off.makespan, \
        f"makespan drift: {on.makespan} != {off.makespan}"
    assert torch.equal(on.z_final, off.z_final), \
        "telemetry changed the committed z (not bitwise)"
    assert list(on.metrics) == list(off.metrics), "metrics key order drift"
    assert on.metrics == off.metrics, "metrics value drift"
    assert _fold_logs(rt_on) == _fold_logs(rt_off), "fold log drift"
    np.testing.assert_array_equal(np.asarray(on.trace.delays),
                                  np.asarray(off.trace.delays),
                                  err_msg="staleness trace drift")

    # --- streamed JSONL schema ----------------------------------------
    records = [json.loads(line)
               for line in jsonl.read_text().splitlines()]
    assert len(records) == ROUNDS, \
        f"expected {ROUNDS} round records, got {len(records)}"
    for rec in records:
        validate_record(rec)
    assert [r["round"] for r in records] == list(range(ROUNDS))
    assert [r["loss"] for r in records] == on.losses, \
        "streamed losses are not the full-precision run losses"

    # --- Chrome trace schema ------------------------------------------
    doc = json.loads(trace.read_text())
    events = doc["traceEvents"]
    assert events, "empty Chrome trace"
    named_tids = {e["tid"] for e in events if e["name"] == "thread_name"}
    for e in events:
        assert e["ph"] in ("X", "i", "C", "M"), f"bad phase {e['ph']!r}"
        assert e["tid"] in named_tids, f"unnamed track tid {e['tid']}"
        if e["ph"] == "M":
            continue
        assert e["name"] in SPAN_NAMES, f"undeclared span {e['name']!r}"
        if e["ph"] == "X":
            assert e["dur"] >= 0.0, f"negative span {e['name']!r}"
    names = {e["name"] for e in events}
    for required in ("pull", "compute", "commit", "server_crash",
                     "wal_replay", "down"):
        assert required in names, f"span family {required!r} missing"

    print(f"[telemetry gate] ok: bitwise z + identical metrics/fold "
          f"logs/makespan ({on.makespan:.4f}) with telemetry on; "
          f"{len(records)} records and {len(events)} trace events "
          f"validated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
