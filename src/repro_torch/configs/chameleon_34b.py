"""chameleon-34b [vlm] — early-fusion; VQ image tokens share the vocab.

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (text + 8192 VQ
image codes), qk-norm. The VQ-VAE image tokenizer is the stubbed
frontend: input_specs() supplies interleaved text+image token ids.
[arXiv:2405.09818]
"""
from .base import ModelConfig

ARCH_ID = "chameleon-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="vlm",
        num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=22016, vocab_size=65536, head_dim=128, qk_norm=True,
        citation="arXiv:2405.09818",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", arch_type="vlm",
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, head_dim=32, qk_norm=True,
        citation="arXiv:2405.09818",
    )
