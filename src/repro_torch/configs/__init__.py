"""Architecture config registry: ``get_config(arch_id)`` / ``get_smoke``.

The port holds the dense GQA architectures whose layers it has: qwen3
(qk-norm), chatglm3 (QKV bias, partial RoPE), qwen1.5 (QKV bias) and
chameleon (qk-norm, early-fusion VLM); the MoE family: mixtral (8
experts top-2, sliding-window attention) and granite-moe (32 experts
top-8); the SSM family: mamba2 (SSD, attention-free); and the hybrid
family: zamba2 (Mamba2 layers, one shared attention block after every
6). Each module is a copy of the reference's
(``repro/configs/<arch>.py``) and cites its source. The reference's
other families (MLA, enc-dec) wait for their slice of the port
(ROADMAP Queue A item 11).
"""
from . import (chameleon_34b, chatglm3_6b, granite_moe_1b, mamba2_370m,
               mixtral_8x7b, qwen1p5_32b, qwen3_1p7b, zamba2_1p2b)
from .base import (ADMMConfig, INPUT_SHAPES, InputShape, MLAConfig,
                   ModelConfig, MoEConfig, SSMConfig)

_MODULES = [zamba2_1p2b, qwen1p5_32b, qwen3_1p7b, mixtral_8x7b,
            granite_moe_1b, mamba2_370m, chameleon_34b, chatglm3_6b]

REGISTRY = {m.ARCH_ID: m for m in _MODULES}


def list_archs():
    return list(REGISTRY)


def _module(arch_id: str):
    if arch_id not in REGISTRY:
        raise KeyError(
            f"arch {arch_id!r} is not in the port; it has {list_archs()}. "
            f"The other model families (MLA, enc-dec) wait "
            f"for ROADMAP Queue A item 11")
    return REGISTRY[arch_id]


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_smoke(arch_id: str):
    return _module(arch_id).smoke()
