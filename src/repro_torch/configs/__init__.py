"""Architecture configs ported so far (one module per arch)."""
from .base import ArchConfig  # noqa: F401
from . import (
    hubert_xlarge,
    internvl2_2b,
    llama2_7b,
    minicpm_2b,
    minitron_4b,
    moonshot_v1_16b_a3b,
    qwen2_moe_a2_7b,
    qwen3_32b,
    recurrentgemma_9b,
    rwkv6_1_6b,
    smollm_135m,
)

_MODULES = [minitron_4b, smollm_135m, minicpm_2b, qwen3_32b, qwen2_moe_a2_7b,
            moonshot_v1_16b_a3b, hubert_xlarge, internvl2_2b, llama2_7b,
            rwkv6_1_6b, recurrentgemma_9b]

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]
