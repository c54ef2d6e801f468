from .admm import server_update, theorem1_feasible, worker_update
from .blocks import (LANE, BlockLayout, FlatBlocks, TreeBlocks,
                     edge_set_from_support, make_block_layout,
                     make_flat_blocks, make_tree_blocks, round_up_to_lane)
from .consensus import (AsyBADMMState, ConsensusProblem, asybadmm_step,
                        init_state, make_problem, make_step_fn, run)
from .metrics import (block_residuals, kkt_violations, stationarity,
                      stationarity_blocks)
from .prox import Regularizer, make_prox, prox_box, prox_l1, soft_threshold
from .space import (BLOCK_SELECTORS, ConsensusSpec, ConsensusState,
                    ConstantDelay, DelayModel, FlatSpace, ParetoDelay,
                    SelectorContext, TraceDelay, TreeSpace, UniformDelay,
                    asybadmm_epoch, consensus_residual, init_consensus_state,
                    make_spec, register_block_selector,
                    resolve_block_selector, state_from_numpy)
