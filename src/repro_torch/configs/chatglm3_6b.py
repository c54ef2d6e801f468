"""chatglm3-6b [dense] — partial ("2d") RoPE, extreme GQA (kv=2).

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
[arXiv:2406.12793]
"""
from .base import ModelConfig

ARCH_ID = "chatglm3-6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="dense",
        num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
        d_ff=13696, vocab_size=65024, head_dim=128,
        qkv_bias=True, rope_fraction=0.5,
        citation="arXiv:2406.12793",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", arch_type="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32,
        qkv_bias=True, rope_fraction=0.5,
        citation="arXiv:2406.12793",
    )
