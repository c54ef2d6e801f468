"""Run configuration: ``ADMMConfig`` (the hyper-parameters of AsyBADMM).

Field names and defaults are the reference's (``repro/configs/base.py``)
so a config reads the same in both packages. ``backend`` names the
port's backends; ``mesh`` takes a mesh of ``torch.distributed`` ranks
(``launch.mesh``) or a preset name; ``autotune`` is accepted but only its
"off" value runs until its slice lands (see ``core.space.make_spec``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Hyper-parameters of AsyBADMM (paper §3, Theorem 1)."""
    rho: float = 100.0          # penalty ρ_i (paper uses 100)
    gamma: float = 0.01         # server prox regularizer γ (paper uses 0.01)
    max_delay: int = 0          # bounded-delay D (Assumption 3); 0 == synchronous
    block_fraction: float = 1.0 # fraction of blocks each worker updates per round
    l1_coef: float = 0.0        # λ for h(z) = λ||z||_1
    clip: Optional[float] = None  # box constraint ||z||_inf <= C
    num_blocks: int = 16        # M logical blocks
    block_selection: str = "random"  # random | cyclic | gauss_southwell | zipf
    zipf_a: float = 1.1         # skew exponent for block_selection="zipf"
                                # (block j sampled with weight (j+1)^-a)
    # incremental/stochastic workers (Hong 2014): fraction of each
    # worker's samples drawn fresh per epoch; None/1.0 = full batch
    minibatch: Optional[float] = None
    # compute backend for the epoch's fused worker/server hot path:
    # torch | cuda | auto (auto = cuda on a CUDA device, torch on the CPU)
    backend: str = "auto"
    # SPMD mesh: None/"none" (one device), a launch.mesh.Mesh of
    # torch.distributed ranks, or a preset name ("test", "pod", "multipod")
    mesh: Any = None
    # kernel tile autotuning: only "off" runs in the port so far
    autotune: str = "off"
    seed: int = 0
