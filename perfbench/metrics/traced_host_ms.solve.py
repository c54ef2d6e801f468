"""Traced host ms a step: host wall ms inside the program's outermost
step span, less the runtime calls that waited on the device
(``spans.WAIT_US``), under the profiler that records every ATen op. The
profiler's own cost is most of it: an upper bound on the host's
dispatch, not a reading of it."""
from perfbench.harness import spans


def read(summary, counts, peaks):
    split = spans.for_summary(summary)
    return None if split is None else split.traced_host_ms
