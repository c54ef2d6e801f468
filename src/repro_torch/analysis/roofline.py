"""Roofline of a counted program on one NVIDIA H100 SXM 80 GB, the
counterpart of ``repro/analysis/roofline.py`` (whose constants are a
TPU's; none is carried over).

Device constants (published, per card):
  HBM3          : 3.35 TB/s
  fp32 (CUDA cores)      :  67 TFLOP/s
  TF32 (tensor cores)    : 495 TFLOP/s
  bf16 / fp16 (tensor cores): 989 TFLOP/s
  NVLink 4      : 450 GB/s a direction (900 GB/s both ways)
  memory        : CARD_MEMORY_BYTES (read on the card)

The compute peak is chosen by the program's dtype and TF32 setting
(:func:`peak_flops`): the port's parity runs keep TF32 off, so an f32
program is held to 67 TFLOP/s. Every input is per card (a counted
shard), so each term is per-card work over a per-card rate:

  compute    = flops / peak
  memory     = hbm_bytes / HBM_BW
  collective = sum_k protocol_factor_k * bytes_k / LINK_BW

with the reference's protocol factors (all-reduce 2x: reduce-scatter
then all-gather; the others 1x on their result bytes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

HBM_BW = 3.35e12            # bytes/s
#: the card's memory, ``torch.cuda.get_device_properties(0).total_memory``
#: on the NVIDIA H100 80GB HBM3 at 700.00 W that the port is measured on
CARD_MEMORY_BYTES = 85_017_493_504
LINK_BW = 450e9             # bytes/s, NVLink 4, one direction
PEAK = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "fp16": 989e12}

_PROTOCOL_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def peak_flops(dtype=torch.float32, tf32: Optional[bool] = None) -> float:
    """The card's peak for a program in ``dtype``: the 16-bit tensor
    cores, TF32's when an f32 program lets its matmuls use it (``tf32``;
    by default torch's current setting), else the fp32 CUDA cores."""
    if dtype in (torch.bfloat16, torch.float16):
        return PEAK["bf16"]
    if tf32 is None:
        tf32 = torch.backends.cuda.matmul.allow_tf32
    return PEAK["tf32"] if tf32 else PEAK["fp32"]


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes: Dict[str, float]
    chips: int
    model_flops_total: float = 0.0      # 6*N*D (active) across the step
    bytes_accessed_peak: float = 0.0    # peak memory, where measured
    peak: float = PEAK["fp32"]          # the card's FLOP/s for this program

    @classmethod
    def from_cost(cls, cost, *, arch: str = "", shape: str = "",
                  mesh: str = "1", chips: int = 1, dtype=torch.float32,
                  tf32: Optional[bool] = None,
                  model_flops_total: float = 0.0) -> "Roofline":
        """The roofline of one card's counted ``analysis.cost.Cost``."""
        return cls(arch=arch, shape=shape, mesh=mesh,
                   flops_per_device=cost.flops,
                   hbm_bytes_per_device=cost.hbm_bytes,
                   collective_bytes=dict(cost.collective_bytes),
                   chips=chips, model_flops_total=model_flops_total,
                   peak=peak_flops(dtype, tf32))

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        t = 0.0
        for kind, b in self.collective_bytes.items():
            if kind == "total":
                continue
            t += _PROTOCOL_FACTOR.get(kind, 1.0) * b / LINK_BW
        return t

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / total counted flops — remat/redundancy waste
        probe."""
        if not self.model_flops_total:
            return None
        return self.model_flops_total / (self.flops_per_device * self.chips)

    @property
    def mfu_bound(self) -> Optional[float]:
        """Upper bound on MFU implied by the roofline (useful flops over
        peak at the bound step time)."""
        if not self.model_flops_total or self.step_time == 0:
            return None
        return (self.model_flops_total / self.chips) / (
            self.step_time * self.peak)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_bound_s": self.step_time,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": sum(
                b for k, b in self.collective_bytes.items() if k != "total"),
        }


def model_flops(cfg, shape) -> float:
    """6 * N_active * tokens for training; 2 * N_active * tokens for a
    forward-only step (prefill); decode processes one token per request."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # decode: 1 tok/request
