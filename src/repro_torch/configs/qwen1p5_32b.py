"""qwen1.5-32b [dense] — QKV bias.

64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064.
[hf:Qwen/Qwen1.5-0.5B]
"""
from .base import ModelConfig

ARCH_ID = "qwen1.5-32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="dense",
        num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
        d_ff=27392, vocab_size=152064, qkv_bias=True,
        citation="hf:Qwen/Qwen1.5-0.5B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", arch_type="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, qkv_bias=True,
        citation="hf:Qwen/Qwen1.5-0.5B",
    )
