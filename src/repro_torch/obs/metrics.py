"""Metrics registry — lazy instruments over the PS runtime's counters.

The determinism contract (see ``repro_torch.obs``) forbids telemetry from
touching the schedule, so the registry inverts the usual push model:
components do NOT increment instruments on the hot path (their plain
attribute counters stay exactly as they were); instead they *register*
an instrument whose value is a zero-argument callback reading those
attributes. ``collect()`` runs the callbacks once, at the end of the
run, in registration order — which is how ``ps/runtime.py`` assembles
``PSRunResult.metrics`` with the exact key order and values the
pre-telemetry dict had (byte-compatible by construction: the callbacks
evaluate the same expressions the inline dict used to).

Instrument names validate against :data:`repro_torch.obs.names.METRICS`
(the stable public spellings); ``register(..., check=False)`` opts a
scratch instrument out (benchmarks register ad-hoc series).

``hist`` is the shared histogram summarizer (promoted from
``ps/runtime.py::_hist``), with the degenerate cases fixed: an empty
input yields all-zero counts over a unit range instead of a phantom
observation at 0, and an all-equal input gets a non-zero-width range
centered on the value.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from .names import METRICS

INSTRUMENT_KINDS = ("counter", "gauge", "histogram", "series")


def hist(values, bins: int = 8) -> Dict[str, list]:
    """Summarize ``values`` into ``{"counts": [...], "edges": [...]}``
    with ``bins`` buckets. Degenerate inputs stay well-formed: empty
    input -> all-zero counts over [0, 1] (no phantom observation);
    all-equal values -> a unit-width range centered on the value
    (numpy would otherwise produce zero-width bins for an explicit
    degenerate range)."""
    if bins < 1:
        raise ValueError(f"hist needs bins >= 1; got {bins}")
    vals = np.asarray(list(values), np.float64)
    if vals.size == 0:
        edges = np.linspace(0.0, 1.0, bins + 1)
        return {"counts": [0] * bins, "edges": [float(e) for e in edges]}
    lo, hi = float(vals.min()), float(vals.max())
    rng = (lo - 0.5, hi + 0.5) if lo == hi else (lo, hi)
    counts, edges = np.histogram(vals, bins=bins, range=rng)
    return {"counts": counts.tolist(), "edges": [float(e) for e in edges]}


class Instrument:
    """One named metric: a kind, a unit, and a value callback."""

    __slots__ = ("name", "kind", "unit", "help", "_fn")

    def __init__(self, name: str, kind: str, unit: str, help_: str,
                 fn: Callable[[], Any]):
        self.name = name
        self.kind = kind
        self.unit = unit
        self.help = help_
        self._fn = fn

    def value(self) -> Any:
        return self._fn()


class TimeSeries:
    """An append-only (sim_time, value) series — the time-bucketed
    instrument kind. Appends are O(1) list pushes (no rng, no events:
    safe on the recording path); ``buckets(width)`` aggregates
    post-hoc."""

    __slots__ = ("points",)

    def __init__(self):
        self.points: List[Tuple[float, float]] = []

    def append(self, t: float, value: float) -> None:
        self.points.append((float(t), float(value)))

    def buckets(self, width: float) -> Dict[str, list]:
        """Aggregate into fixed-width time buckets: per-bucket count,
        sum, and last value. Empty series -> empty buckets."""
        if width <= 0:
            raise ValueError(f"bucket width must be > 0; got {width}")
        out: Dict[int, list] = {}
        for (t, v) in self.points:
            b = int(t // width)
            slot = out.setdefault(b, [0, 0.0, v])
            slot[0] += 1
            slot[1] += v
            slot[2] = v
        return {"width": width,
                "buckets": [{"t0": b * width, "count": c, "sum": s,
                             "last": last}
                            for b, (c, s, last) in sorted(out.items())]}

    def value(self) -> List[Tuple[float, float]]:
        return list(self.points)


class MetricsRegistry:
    """Named instruments, collected once in registration order."""

    def __init__(self):
        self._instruments: Dict[str, Instrument] = {}
        self._series: Dict[str, TimeSeries] = {}

    # ------------------------------------------------------------------
    def register(self, name: str, kind: str, fn: Callable[[], Any], *,
                 unit: str = "", help: str = "",
                 check: bool = True) -> Instrument:
        """Register instrument ``name`` with value callback ``fn``.
        Registered names must appear in ``repro_torch.obs.names.METRICS``
        with a matching kind (``check=False`` skips — scratch/benchmark
        instruments); duplicate registration is an error (the runtime
        assembles its metrics dict from these, and a silent overwrite
        would reorder or clobber a public key)."""
        if kind not in INSTRUMENT_KINDS:
            raise ValueError(f"unknown instrument kind {kind!r}; "
                             f"expected one of {INSTRUMENT_KINDS}")
        if name in self._instruments:
            raise ValueError(f"instrument {name!r} already registered")
        if check:
            decl = METRICS.get(name)
            if decl is None:
                raise ValueError(
                    f"metric name {name!r} is not declared in "
                    f"repro_torch.obs.names.METRICS; declare it there (the "
                    f"stable-name contract) or register with "
                    f"check=False for a scratch instrument")
            if decl[0] != kind:
                raise ValueError(
                    f"metric {name!r} is declared as a {decl[0]} in "
                    f"repro_torch.obs.names.METRICS but registered as a "
                    f"{kind}")
            if not unit:
                unit = decl[1]
            if not help:
                help = decl[2]
        inst = Instrument(name, kind, unit, help, fn)
        self._instruments[name] = inst
        return inst

    def counter(self, name: str, fn: Callable[[], Any],
                **kw) -> Instrument:
        return self.register(name, "counter", fn, **kw)

    def gauge(self, name: str, fn: Callable[[], Any], **kw) -> Instrument:
        return self.register(name, "gauge", fn, **kw)

    def histogram(self, name: str, fn: Callable[[], Any],
                  **kw) -> Instrument:
        """A histogram instrument: ``fn`` returns the raw observations;
        ``collect`` summarizes them via :func:`hist`."""
        return self.register(name, "histogram", lambda: fn(), **kw)

    def series(self, name: str, *, check: bool = False) -> TimeSeries:
        """Create (or fetch) a named append-only time series. Series
        are scratch by default (``check=False``): they are recording
        surfaces, not ``PSRunResult.metrics`` keys."""
        ts = self._series.get(name)
        if ts is None:
            ts = self._series[name] = TimeSeries()
            self.register(name, "series", ts.value, check=check)
        return ts

    # ------------------------------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def get(self, name: str) -> Optional[Instrument]:
        return self._instruments.get(name)

    def describe(self) -> List[Dict[str, str]]:
        """The instrument table (name/kind/unit/help) in registration
        order — what API.md's metric table documents."""
        return [{"name": i.name, "kind": i.kind, "unit": i.unit,
                 "help": i.help} for i in self._instruments.values()]

    def collect(self, names: Optional[List[str]] = None) -> Dict[str, Any]:
        """Evaluate instruments (all, or the ``names`` subset) in
        registration order and return the name -> value dict."""
        insts = self._instruments.values() if names is None else \
            [self._instruments[n] for n in names]
        return {i.name: i.value() for i in insts}
