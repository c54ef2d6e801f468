"""The paper's benchmark scripts, ported: ``convergence`` (the Fig. 2
analogue). Runs as ``python -m repro_torch.benchmarks.convergence``, on
the card unless ``--device cpu`` is given."""
