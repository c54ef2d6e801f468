"""Train-state containers for both trainers, as
``repro/training/train_state.py``.

The reference's ``ADMMTrainState`` also carries a threefry key; the
port's has none: its draws come from generators seeded from the
config's seed, the step and a stream id (``core.space``), so ``step``
alone fixes them and a checkpoint of ``_asdict()`` resumes exactly."""
from __future__ import annotations

from typing import Any, NamedTuple

from ..core.tree import tree_map


class SGDTrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int


class ADMMTrainState(NamedTuple):
    """State of the block-wise consensus trainer (pytree mode).

    z_hist : pytree; every leaf has leading axis (D+1,) — the bounded-
             staleness ring buffer (index 0 = newest consensus params).
    y      : pytree; leaves have leading worker axis (N, ...) — duals.
             By eq. (25) these are exactly -(last gradient) per worker.
    w_cache: pytree; leaves (N, ...) — server-side stale w~ cache
             (``()`` for a state built with ``init(cyclic=True)``).
    step   : the step counter (with the config's seed it fixes the
             step's random draws).
    """
    z_hist: Any
    y: Any
    w_cache: Any
    step: int

    @property
    def params(self):
        return tree_map(lambda a: a[0], self.z_hist)
