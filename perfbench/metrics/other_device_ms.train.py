"""Device ms a step in every operation but B1 and B2: the epoch's plain
torch ops (gather, worker gradient, select, push) and the model's."""
from perfbench.harness.readers import other_device_ms


def read(summary, counts, peaks):
    return other_device_ms(summary)
