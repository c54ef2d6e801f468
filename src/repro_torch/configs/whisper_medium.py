"""whisper-medium [audio] — encoder-decoder; conv frontend stubbed.

24L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=51865.
input_specs() supplies precomputed mel/conv frame embeddings
(B, 1500, d_model); the transformer backbone is what we implement.
[arXiv:2212.04356]
"""
from .base import ModelConfig

ARCH_ID = "whisper-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="audio",
        num_layers=24, encoder_layers=24, encoder_seq_len=1500,
        d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=4096, vocab_size=51865, act="gelu",
        citation="arXiv:2212.04356",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", arch_type="audio",
        num_layers=2, encoder_layers=2, encoder_seq_len=16,
        d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, act="gelu",
        citation="arXiv:2212.04356",
    )
