"""Device ms a step of the operations launched inside the program's
``asybadmm.gather`` span: the delay draw and the gather of z~ from the
ring."""
from perfbench.harness import spans


def read(summary, counts, peaks):
    split = spans.for_summary(summary)
    return None if split is None else split.device_ms(spans.GATHER)
