from . import ops, ref
from .ops import (admm_worker_select_update, launch_counts, prox_consensus,
                  reset_launch_counts, server_prox_update)
