"""FLOPs and bytes of one ADMM training step of the MLA decoder
(``reference/mla_transformer.py``), for the rooflines.

FLOPs, the least the step needs: forward and backward of every matrix
product at 6 FLOPs per weight and token (2 forward, 4 backward; the
embedding is a gather, the LM head a product), plus causal attention:
per layer, sequence and head, S (S + 1) / 2 query-key pairs, each 2
(qk_nope + qk_rope) FLOPs for the score and 2 v_head_dim for the
output, times 3 for the backward. No recompute, no masked half.

Bytes of the ADMM epoch on the (N, M, dblk) table (``counts/flat.py``
for B1's and B2's rules, without x; training selects every block).
The step's least bytes: one version of z read, y read, y and w written
for every worker, z written: (2 + 3 N) tables of the parameters.
"""
from __future__ import annotations

import math
from typing import Dict

from ..reference import admm_tree, mla_transformer
from . import flat

ELEM = 4


def matmul_params(cfg: Dict) -> int:
    k = mla_transformer.dims(cfg)
    d, nq = k["d"], k["nq"]
    per_layer = (d * k["ql"] + k["ql"] * nq * (k["nope"] + k["rope"])
                 + d * (k["kvl"] + k["rope"])
                 + k["kvl"] * nq * (k["nope"] + k["vd"])
                 + nq * k["vd"] * d + 3 * d * k["ff"])
    return k["L"] * per_layer + d * k["V"]


def attention_flops(cfg: Dict, sequences: int, seq_len: int) -> int:
    k = mla_transformer.dims(cfg)
    pairs = seq_len * (seq_len + 1) // 2
    fwd = 2 * k["nq"] * pairs * (k["nope"] + k["rope"] + k["vd"])
    return 3 * fwd * k["L"] * sequences


def params(cfg: Dict) -> int:
    return sum(int(math.prod(shape)) for shape, _ in
               mla_transformer.param_shapes(cfg).values())


def table_dblk(cfg: Dict, blocks: int) -> int:
    shapes = mla_transformer.param_shapes(cfg)
    sizes = [int(math.prod(shapes[p][0]))
             for p in sorted(shapes)]
    biggest = max(admm_tree.block_sizes(sizes, blocks))
    return -(-biggest // 128) * 128


def step(cfg: Dict, workers: int, blocks: int, sequences: int,
         seq_len: int) -> Dict[str, float]:
    """Counts of one step: every worker trains ``sequences`` sequences
    of ``seq_len`` tokens; every (worker, block) pair an edge, every
    block selected."""
    tokens = workers * sequences * seq_len
    flops = (6 * matmul_params(cfg) * tokens
             + attention_flops(cfg, workers * sequences, seq_len))
    dblk = table_dblk(cfg, blocks)
    epoch = flat.epoch([[True] * blocks] * workers, 1.0, dblk, False)
    return {"step_flops": flops,
            "step_bytes": (2 + 3 * workers) * params(cfg) * ELEM,
            "b1_bytes": epoch["b1_bytes"], "b2_bytes": epoch["b2_bytes"],
            "tokens": tokens, "dblk": dblk}
