"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64.
[arXiv:2411.15242]
"""
from .base import ModelConfig, SSMConfig

ARCH_ID = "zamba2-1.2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="hybrid",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32000, head_dim=64,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2),
        hybrid_attn_every=6,
        citation="arXiv:2411.15242",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", arch_type="hybrid",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, head_dim=32,
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, chunk_size=16),
        hybrid_attn_every=1,
        citation="arXiv:2411.15242",
    )
