"""Cost analysis of the port's programs, the counterpart of
``repro/analysis/``: ``cost`` counts what a program runs (FLOPs, HBM
bytes, collective bytes, ops), ``roofline`` turns a count into the
H100's time bounds, ``report`` prints them. ``hooks`` is where the
kernels' dispatch and the mesh's collectives report to a counter; it
imports nothing, so the packages it serves can import it."""
