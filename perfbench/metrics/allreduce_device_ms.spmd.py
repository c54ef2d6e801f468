"""Device ms a step in NCCL's kernels (every kernel whose name holds
``nccl``) on the traced rank: the all-reduce of the w sum over the data
group and the loss's scalar. A collective's kernel runs from its launch
until the slowest rank has joined, so the time includes that wait."""

NCCL = "nccl"


def read(summary, counts, peaks):
    launches, seconds = summary.launches(NCCL)
    if launches == 0:
        return None
    return 1e3 * seconds / summary.steps
