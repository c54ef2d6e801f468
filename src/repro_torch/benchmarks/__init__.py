"""The paper's benchmark scripts, ported: ``convergence`` (the Fig. 2
analogue) and ``speedup`` (the Table 1 analogue, on the PS runtime).
Each runs as ``python -m repro_torch.benchmarks.<name>``, on the card
unless ``--device cpu`` is given."""
