"""Device ms a step of the operations launched inside the program's
``asybadmm.select`` span: the block selector, the participation mask
and the info means."""
from perfbench.harness import spans


def read(summary, counts, peaks):
    split = spans.for_summary(summary)
    return None if split is None else split.device_ms(spans.SELECT)
