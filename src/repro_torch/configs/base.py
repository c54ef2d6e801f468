"""Model and run configuration: ``ModelConfig`` (with ``MoEConfig``,
``SSMConfig``, ``MLAConfig``), ``ADMMConfig`` (the hyper-parameters of
AsyBADMM) and the ``INPUT_SHAPES`` of the model cells.

Field names and defaults are the reference's (``repro/configs/base.py``)
so a config reads the same in both packages; ``ModelConfig.jnp_dtype``
becomes ``torch_dtype``. ``backend`` names the port's backends; ``mesh``
takes a mesh of ``torch.distributed`` ranks (``launch.mesh``) or a
preset name; ``autotune`` picks where the fused epoch kernels' launches
come from (``kernels.autotune``: off, cached, sweep).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int                  # per-expert hidden dim
    router_aux_coef: float = 0.01   # load-balance loss coefficient
    capacity_factor: float = 1.25   # GShard capacity; >= num_experts/top_k => dropless


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int                  # d_state (N in Mamba2)
    head_dim: int = 64              # P in Mamba2 (channels per SSD head)
    expand: int = 2                 # d_inner = expand * d_model
    chunk_size: int = 256           # SSD chunk length
    conv_width: int = 4             # depthwise causal conv window


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                  # query heads (0 for attn-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    # --- attention flavour flags ---
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_fraction: float = 1.0      # <1.0 => partial ("2d") RoPE (ChatGLM)
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None   # SWA width (Mixtral)
    mla: Optional[MLAConfig] = None
    # --- mixture / ssm / hybrid ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0      # hybrid: 1 shared attn block every k SSM layers
    # --- enc-dec (audio) ---
    encoder_layers: int = 0         # >0 => encoder-decoder
    encoder_seq_len: int = 1500     # stub frontend frame count (Whisper 30s)
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"             # swiglu | gelu
    dtype: str = "float32"          # compute dtype
    param_dtype: str = "float32"
    remat: bool = False             # activation checkpointing in the layer stack
    attn_impl: str = "naive"        # naive (materialized S^2) | flash (B7) | chunked | qchunk
    attn_chunk: int = 1024          # query/key block for chunked attention
    moe_impl: str = "onehot"        # onehot (GShard einsum) | scatter (index dispatch)
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve 500k-token contexts (per-step cost not O(L^2),
        decode KV memory bounded)?"""
        return (
            self.arch_type in ("ssm", "hybrid")
            or self.sliding_window is not None
        )

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def torch_param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6 N D) ----
    def param_count(self, active_only: bool = False) -> int:
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        per_layer = 0
        if self.arch_type == "ssm" or (self.arch_type == "hybrid"):
            if self.ssm is None:
                raise ValueError("ssm config required")
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            # in_proj (z,x,B,C,dt) + out_proj + conv + norms (B,C per group, G=1)
            per_layer_ssm = d * (2 * di + 2 * self.ssm.state_dim + nh) + di * d
            per_layer_ssm += self.ssm.conv_width * (di + 2 * self.ssm.state_dim)
            per_layer_ssm += 2 * d + di
        if self.arch_type == "ssm":
            per_layer = per_layer_ssm
        else:
            attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
            if self.mla is not None:
                m = self.mla
                attn = (
                    d * m.q_lora_rank
                    + m.q_lora_rank * nq * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
                    + nq * m.v_head_dim * d
                )
            if self.moe is not None:
                n_mlp_experts = self.moe.top_k if active_only else self.moe.num_experts
                mlp = n_mlp_experts * 3 * d * self.moe.expert_ff + d * self.moe.num_experts
            elif self.act == "swiglu":
                mlp = 3 * d * ff
            else:
                mlp = 2 * d * ff
            per_layer = attn + mlp + 2 * d
        total = 0
        if self.arch_type == "hybrid":
            n_attn = self.num_layers // max(self.hybrid_attn_every, 1)
            total += (self.num_layers) * per_layer_ssm + n_attn * per_layer
        else:
            total += self.num_layers * per_layer
        if self.encoder_layers:
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            total += self.encoder_layers * per_layer
            total += self.num_layers * (d * nq * hd + 2 * d * nkv * hd + nq * hd * d)
        total += V * d  # embeddings
        if not self.tie_embeddings:
            total += V * d
        return int(total)


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
    # B1 / B2 launch autotuning (kernels/autotune.py): off (the kernels'
    # default launches) | cached (the tuned table) | sweep (measure, then
    # cached)
    autotune: str = "off"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
