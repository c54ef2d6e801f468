"""The general parts of the benchmark: the manifest, the timed window,
the profiler's reduction, the seeded inputs and the result line."""
