"""The share of the traced window in which no operation ran on the
device."""
from perfbench.harness.readers import idle_pct


def read(summary, counts, peaks):
    return idle_pct(summary)
