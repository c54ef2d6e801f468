"""B1 (csrc/admm_update.cu, the worker update): its call's bytes at the
card's bandwidth over its profiler device time per launch."""
from perfbench.harness.readers import B1, kernel_roofline


def read(summary, counts, peaks):
    return kernel_roofline(summary, counts, peaks, B1, "b1_bytes")
