"""The paper's example scripts, ported: ``quickstart`` (one AsyBADMM run
with its KKT check) and ``sparse_logreg_admm`` (sync vs async vs
full-vector, with the logistic-gradient kernels cross-checked against
autograd). Each has a ``main`` that returns its numbers, and runs as
``python -m repro_torch.examples.<name>``, on the card unless
``--device cpu`` is given."""
