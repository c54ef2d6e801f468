"""The numbers that decide ``correct``, each with its limit, and the
gaps they are made of."""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def table_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|: a table's widest gap against
    its own scale (inf where shapes differ or a value is not finite)."""
    if got.shape != want.shape:
        return math.inf
    scale = float(torch.max(torch.abs(want)))
    gap = float(torch.max(torch.abs(got.float() - want.float())))
    gap = gap / scale if scale > 0 else gap
    return gap if math.isfinite(gap) else math.inf


def norm_gap(got: Sequence[float], want: Sequence[float],
             keep: Sequence[bool] = None) -> float:
    """The worst leaf's |got - want| over the larger of want's norm of
    that leaf and of the median leaf (over the leaves kept)."""
    keep = keep if keep is not None else [True] * len(want)
    kept = [w for w, k in zip(want, keep) if k]
    if not kept:
        return math.inf
    median = statistics.median(kept)
    return _worst(abs(g - w) / max(w, median)
                  for g, w, k in zip(got, want, keep) if k)


def loss_gap(got: Sequence[float], want: Sequence[float]) -> float:
    """The worst step's relative gap of the loss."""
    return _worst(abs(g - w) / abs(w) for g, w in zip(got, want))


def _worst(gaps) -> float:
    """The largest gap; inf if any is not finite (NaN never compares)."""
    worst = 0.0
    for gap in gaps:
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def checks(values: Dict[str, float], limits: Dict[str, float]
           ) -> List[Check]:
    return [Check(name, float(values[name]), float(limits[name]))
            for name in limits]
