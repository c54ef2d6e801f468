"""Device ms a step of the operations launched inside the program's
``asybadmm.loss`` span from an ``autograd::engine::evaluate_function``
op: the loss's backward."""
from perfbench.harness import spans


def read(summary, counts, peaks):
    split = spans.for_summary(summary)
    return None if split is None else split.device_ms(spans.BACKWARD)
