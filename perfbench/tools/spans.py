#!/usr/bin/env python3
"""Print a traced run's window split by the program's step spans
(``harness/spans.py``), one JSON object:

    python3 perfbench/tools/spans.py perfbench/out/traces/<cell>.json

Per step (steps = the outermost step spans opened in the window): the
device ms of each part, the total, the six parts' share of the device
time outside B1 and B2, the traced host ms, the cudaMalloc calls, and
the histogram of the launch calls' durations that ``spans.WAIT_US`` is
set from.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT)]

from perfbench.harness import readers, spans, trace  # noqa: E402

EDGES_US = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)


def launch_histogram(events) -> list:
    """Counts of the window's launch calls by duration, between
    ``EDGES_US``."""
    w0, w1 = spans.window(events)
    counts = [0] * (len(EDGES_US) + 1)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in spans.RUNTIME_CATS \
                and e.get("name", "").startswith(spans.LAUNCHES) \
                and w0 <= e["ts"] <= w1:
            counts[sum(e.get("dur", 0) > edge for edge in EDGES_US)] += 1
    return counts


def report(path: Path) -> dict:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    probe = spans.split_events(events, 1)
    if probe is None:
        return {"steps": 0}
    steps = probe.spans.get(spans.TRAIN_STEP) or probe.spans[spans.EPOCH]
    split = spans.split_events(events, steps)
    summary = trace.summarize(path, steps)
    b1b2 = (summary.launches(readers.B1)[1]
            + summary.launches(readers.B2)[1])
    total = sum(split.device_s.values())
    six = (spans.GATHER, spans.UNPACK, spans.PACK, spans.FORWARD,
           spans.BACKWARD, spans.SELECT, spans.PUSH)
    other = total - b1b2
    return {
        "steps": steps,
        "device_ms": {part: 1e3 * s / steps
                      for part, s in split.device_s.items()},
        "total_device_ms": 1e3 * total / steps,
        "other_device_ms": 1e3 * other / steps,
        "six_share_of_other": sum(split.device_s.get(p, 0.0)
                                  for p in six) / other if other else None,
        "no_span_share": split.device_s.get(spans.NO_SPAN, 0.0) / total,
        "traced_host_ms": split.traced_host_ms, "wait_us": spans.WAIT_US,
        "malloc_calls": split.malloc_calls / steps,
        "launch_us_hist": {"edges": EDGES_US,
                           "counts": launch_histogram(events)},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace")
    args = ap.parse_args(argv)
    print(json.dumps(report(Path(args.trace))), flush=True)


if __name__ == "__main__":
    main()
