"""One driver per entry kind, found by the ``driver`` key of a
configuration: ``flat_solve`` and ``admm_train``."""
