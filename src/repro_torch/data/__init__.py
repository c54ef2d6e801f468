from .sparse import SparseLogRegData, make_sparse_logreg
from .synthetic import TokenPipeline
