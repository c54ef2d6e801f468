"""granite-moe-1b-a400m [moe] — 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512 (per expert) vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from .base import ModelConfig, MoEConfig

ARCH_ID = "granite-moe-1b-a400m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="moe",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
        d_ff=512, vocab_size=49155, head_dim=64,
        moe=MoEConfig(num_experts=32, top_k=8, expert_ff=512),
        citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", arch_type="moe",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=512, head_dim=32,
        moe=MoEConfig(num_experts=4, top_k=2, expert_ff=64, capacity_factor=4.0),
        citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
