"""Where a cost counter (``analysis/cost.py``) meets the code it counts.

The hand-written kernels are launched through ``ctypes``, where no
``TorchDispatchMode`` sees them, and a collective is one op whatever it
does on the host. So ``kernels/ops.py`` reports every kernel dispatch,
and ``core/sharded.py`` every collective, through the two functions
here: with no counter recording they just run the call; with one, the
counter charges the call's declared cost and runs it uncounted."""
from __future__ import annotations

# the counter recording now (``analysis.cost._Counter``), or None
counter = None


def kernel(name: str, operands: tuple, run):
    """``run()``, a dispatch of kernel ``name`` on ``operands``."""
    c = counter
    return run() if c is None else c.kernel(name, operands, run)


def collective(kind: str, x, run):
    """``run()``, a collective of ``kind`` (``all-reduce``,
    ``all-gather``, ``all-to-all``) on ``x``."""
    c = counter
    return run() if c is None else c.collective(kind, x, run)
