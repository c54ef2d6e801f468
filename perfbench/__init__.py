"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything a cell
needs is found by name: its configuration under ``configs/``, its
traffic under ``workloads/``, the driver its configuration names under
``drivers/``, the plain reference under ``reference/``, and one reader
per per-layer metric under ``metrics/``. ``counts/`` holds the FLOP and
byte formulas and the card's published peaks. Nothing here imports JAX
or the JAX package, and nothing under ``reference/`` or ``counts/``
imports the port.
"""
