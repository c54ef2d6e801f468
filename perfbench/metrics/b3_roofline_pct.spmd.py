"""B3 (csrc/prox_update.cu, the prox from the all-reduced w sum): its
call's bytes at the card's bandwidth over its profiler device time per
launch."""
from perfbench.harness.readers import kernel_roofline

B3 = "prox_consensus_kernel"


def read(summary, counts, peaks):
    return kernel_roofline(summary, counts, peaks, B3, "b3_bytes")
