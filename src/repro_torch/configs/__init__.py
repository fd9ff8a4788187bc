"""Architecture configs ported so far (one module per arch)."""
from .base import ArchConfig  # noqa: F401
from . import llama2_7b

_MODULES = [llama2_7b]

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKES = {m.CONFIG.name: m.SMOKE for m in _MODULES}


def get_arch(name: str, smoke: bool = False) -> ArchConfig:
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]
