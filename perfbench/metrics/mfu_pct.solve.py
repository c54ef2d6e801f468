"""The whole step's share of the card's peak: the least time its FLOPs
and bytes (``counts/``) take at the published peaks, over the traced
window's mean step time."""
from perfbench.harness.readers import step_share


def read(summary, counts, peaks):
    return step_share(summary, counts, peaks)
