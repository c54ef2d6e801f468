"""B2 (csrc/prox_update.cu, the edge-masked reduce and prox): its
call's bytes at the card's bandwidth over its profiler device time per
launch."""
from perfbench.harness.readers import B2, kernel_roofline


def read(summary, counts, peaks):
    return kernel_roofline(summary, counts, peaks, B2, "b2_bytes")
