"""qwen3-1.7b [dense] — qk-norm, GQA.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
[hf:Qwen/Qwen3-8B]
"""
from .base import ModelConfig

ARCH_ID = "qwen3-1.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="dense",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
        d_ff=6144, vocab_size=151936, head_dim=128,
        qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0,
        citation="hf:Qwen/Qwen3-8B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", arch_type="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32,
        qk_norm=True, tie_embeddings=True,
        citation="hf:Qwen/Qwen3-8B",
    )
