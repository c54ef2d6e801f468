"""minicpm3-4b [dense] — Multi-head Latent Attention (MLA).

62L d_model=2560 40H (GQA kv=40) d_ff=6400 vocab=73448.
[hf:openbmb/MiniCPM3-4B]
"""
from .base import MLAConfig, ModelConfig

ARCH_ID = "minicpm3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="dense",
        num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
        d_ff=6400, vocab_size=73448,
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
        citation="hf:openbmb/MiniCPM3-4B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", arch_type="dense",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512,
        mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        citation="hf:openbmb/MiniCPM3-4B",
    )
