"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
SWA(4096) makes this the dense-attention arch eligible for long_500k.
[arXiv:2401.04088]
"""
from .base import ModelConfig, MoEConfig

ARCH_ID = "mixtral-8x7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=32000, head_dim=128,
        sliding_window=4096,
        moe=MoEConfig(num_experts=8, top_k=2, expert_ff=14336),
        citation="arXiv:2401.04088",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", arch_type="moe",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32, sliding_window=32,
        moe=MoEConfig(num_experts=4, top_k=2, expert_ff=256, capacity_factor=4.0),
        citation="arXiv:2401.04088",
    )
