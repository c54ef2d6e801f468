"""Learning-rate schedules (callable on the int step), as
``repro/optim/schedule.py``: float32 arithmetic, a Python float out."""
from __future__ import annotations

import numpy as np


def constant(value: float):
    return lambda step: value


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def f(step):
        step = np.float32(int(step))
        if step < warmup_steps:
            return float(np.float32(peak) * step
                         / np.float32(max(warmup_steps, 1)))
        frac = np.clip((step - np.float32(warmup_steps))
                       / np.float32(max(total_steps - warmup_steps, 1)),
                       np.float32(0.0), np.float32(1.0))
        return float(np.float32(floor) + np.float32(0.5)
                     * np.float32(peak - floor)
                     * (np.float32(1.0) + np.cos(np.float32(np.pi) * frac)))
    return f
