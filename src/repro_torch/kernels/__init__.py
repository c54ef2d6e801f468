from . import ops, ref
from .ops import (admm_worker_select_update, admm_worker_update,
                  launch_counts, logreg_grad, matmul, prox_consensus,
                  reset_launch_counts, server_prox_update)
