"""What the per-layer readers under ``metrics/`` share. Each reader is
``read(summary, counts, peaks)``: the traced window's ``Summary``, the
yardstick's counts of one step and the card's peaks; it returns a
number, or None when it finds nothing to read (no launch of its kernel,
no peak for the card), and never 0 for a share."""
from __future__ import annotations

from typing import Dict, Optional

from .trace import Summary

# the port's kernel names (csrc/admm_update.cu, csrc/prox_update.cu)
B1 = "worker_select_update_kernel"
B2 = "server_prox_kernel"


def step_seconds(summary: Summary) -> float:
    return summary.window_s / summary.steps


def step_share(summary: Summary, counts: Dict, peaks) -> Optional[float]:
    """The least time the step's FLOPs and bytes take at the card's
    peaks, over the window's mean step time, in %."""
    if peaks is None:
        return None
    least = max(counts["step_flops"] / peaks["fp32_flops_per_s"],
                counts["step_bytes"] / peaks["hbm_bytes_per_s"])
    return 100.0 * least / step_seconds(summary)


def kernel_roofline(summary: Summary, counts: Dict, peaks, fragment: str,
                    key: str) -> Optional[float]:
    """The kernel's bytes a call at the card's bandwidth over its device
    time per launch, in %."""
    launches, seconds = summary.launches(fragment)
    if peaks is None or launches == 0 or seconds <= 0:
        return None
    return 100.0 * (counts[key] / peaks["hbm_bytes_per_s"]) / (
        seconds / launches)


def other_device_ms(summary: Summary) -> Optional[float]:
    """Device ms a step in every operation but B1 and B2."""
    rest = (summary.kernel_seconds - summary.launches(B1)[1]
            - summary.launches(B2)[1])
    return 1e3 * rest / summary.steps


def idle_pct(summary: Summary) -> Optional[float]:
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
