"""``cudaMalloc`` calls a step made inside the program's
``admm.train_step`` span: the caching allocator's calls to the driver."""
from perfbench.harness import spans


def read(summary, counts, peaks):
    split = spans.for_summary(summary)
    if split is None or not split.spans.get(spans.TRAIN_STEP):
        return None
    return split.malloc_calls / split.steps
