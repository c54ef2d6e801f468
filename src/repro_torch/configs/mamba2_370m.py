"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1024 d_ff=0 vocab=50280, ssm_state=128.
[arXiv:2405.21060]
"""
from .base import ModelConfig, SSMConfig

ARCH_ID = "mamba2-370m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="ssm",
        num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2),
        tie_embeddings=True,
        citation="arXiv:2405.21060",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", arch_type="ssm",
        num_layers=2, d_model=128, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, chunk_size=16),
        tie_embeddings=True,
        citation="arXiv:2405.21060",
    )
