"""Architecture config registry: ``get_config(arch_id)`` / ``get_smoke``.

The port holds the dense GQA architectures whose layers it has: qwen3
(qk-norm), chatglm3 (QKV bias, partial RoPE), qwen1.5 (QKV bias) and
chameleon (qk-norm, early-fusion VLM); the MoE family: mixtral (8
experts top-2, sliding-window attention) and granite-moe (32 experts
top-8); the SSM family: mamba2 (SSD, attention-free); and the hybrid
family: zamba2 (Mamba2 layers, one shared attention block after every
6); MLA: minicpm3 (Multi-head Latent Attention, the absorbed decode over
a latent cache); and the encoder-decoder family: whisper (a
bidirectional encoder over stub frame embeddings, a decoder with
cross-attention). These are all ten of the reference's archs. Each
module is a copy of the reference's (``repro/configs/<arch>.py``) and
cites its source.
"""
from . import (chameleon_34b, chatglm3_6b, granite_moe_1b, mamba2_370m,
               minicpm3_4b, mixtral_8x7b, qwen1p5_32b, qwen3_1p7b,
               whisper_medium, zamba2_1p2b)
from .base import (ADMMConfig, INPUT_SHAPES, InputShape, MLAConfig,
                   ModelConfig, MoEConfig, SSMConfig)

_MODULES = [zamba2_1p2b, minicpm3_4b, qwen1p5_32b, whisper_medium,
            qwen3_1p7b, mixtral_8x7b, granite_moe_1b, mamba2_370m,
            chameleon_34b, chatglm3_6b]

REGISTRY = {m.ARCH_ID: m for m in _MODULES}


def list_archs():
    return list(REGISTRY)


def _module(arch_id: str):
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; the port has "
                       f"{list_archs()}")
    return REGISTRY[arch_id]


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_smoke(arch_id: str):
    return _module(arch_id).smoke()
