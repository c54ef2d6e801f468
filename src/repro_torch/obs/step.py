"""Step spans: wall-clock ranges at the boundaries of the port's step.

``step_span(name)`` is a context manager. While a ``torch.profiler``
session records (the benchmark's traced runs, ``launch/train.py
--profile-dir``) it opens a ``RecordFunction`` range named ``name``, so
the range lands in the profiler's own trace, on the clock of the kernels
and CUDA runtime calls it encloses: a trace reader charges each device
operation to the span open when its launch was made. Otherwise it is
one shared no-op context after one boolean check, with no dispatcher
call, no ``RecordFunction`` and no allocation.

The range is PyTorch's C++ fast path, ``_RecordFunctionFast`` (a
``cpu_op`` event in the trace): ``torch.profiler.record_function`` goes
through the dispatcher, ~15 µs a range on a CPU where the fast path
takes ~2, and a traced epoch opens eight.

Names validate against :data:`repro_torch.obs.names.STEP_SPANS` while
recording. Spans sit outside ``vmap`` / ``grad``, never inside a user's
loss.
"""
from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

from .names import STEP_SPANS

_OFF = contextlib.nullcontext()
_RANGE = torch._C._profiler._RecordFunctionFast


def step_span(name: str):
    """The span ``name`` while a profiler records, else a no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if name not in STEP_SPANS:
        raise ValueError(
            f"unknown step span {name!r}; registered spans: "
            f"{sorted(STEP_SPANS)}. Register new spans in "
            f"repro_torch.obs.names.STEP_SPANS.")
    return _RANGE(name)
