"""Device ms a step of the operations launched inside the program's
``asybadmm.unpack`` and ``asybadmm.pack`` spans: z~ off the block table
into the loss's representation, and the gradient back onto it."""
from perfbench.harness import spans


def read(summary, counts, peaks):
    split = spans.for_summary(summary)
    return None if split is None else split.device_ms(spans.UNPACK, spans.PACK)
