"""Architecture config registry: ``get_config(arch_id)`` / ``get_smoke``.

The port holds the dense GQA architectures whose layers it has: qwen3
(qk-norm), chatglm3 (QKV bias, partial RoPE), qwen1.5 (QKV bias) and
chameleon (qk-norm, early-fusion VLM); and the MoE family: mixtral
(8 experts top-2, sliding-window attention) and granite-moe (32
experts top-8). Each module is a copy of the reference's
(``repro/configs/<arch>.py``) and cites its source. The reference's
other families (MLA, SSM, hybrid, enc-dec) wait for their slice of the
port (ROADMAP Queue A item 11).
"""
from . import (chameleon_34b, chatglm3_6b, granite_moe_1b, mixtral_8x7b,
               qwen1p5_32b, qwen3_1p7b)
from .base import (ADMMConfig, INPUT_SHAPES, InputShape, MLAConfig,
                   ModelConfig, MoEConfig, SSMConfig)

_MODULES = [qwen1p5_32b, qwen3_1p7b, mixtral_8x7b, granite_moe_1b,
            chameleon_34b, chatglm3_6b]

REGISTRY = {m.ARCH_ID: m for m in _MODULES}


def list_archs():
    return list(REGISTRY)


def _module(arch_id: str):
    if arch_id not in REGISTRY:
        raise KeyError(
            f"arch {arch_id!r} is not in the port; it has {list_archs()}. "
            f"The other model families (MLA, SSM, hybrid, enc-dec) wait "
            f"for ROADMAP Queue A item 11")
    return REGISTRY[arch_id]


def get_config(arch_id: str):
    return _module(arch_id).config()


def get_smoke(arch_id: str):
    return _module(arch_id).smoke()
