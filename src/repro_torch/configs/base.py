"""Architecture configuration schema (the torch port's copy of
``repro/configs/base.py``; the shape grid and skip rules arrive with the
families and benchmarks that use them)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | rwkv6 | hybrid_rglru | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    use_rope: bool = True
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_topk: int = 0
    d_ff_expert: int = 0
    # hybrid (recurrentgemma): 1 attention block per `group` of blocks
    window: int = 0
    rec_per_attn: int = 0
    conv_width: int = 4
    lru_dim: int = 0
    # rwkv
    wkv_heads: int = 0
    # io
    input_mode: str = "tokens"  # tokens | frames | tokens_patches
    n_patches: int = 256
    causal: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Dense-family parameter count (embed + untied head + layers)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.hd
        attn = D * (self.n_heads * hd) + 2 * D * (self.n_kv_heads * hd) + (
            self.n_heads * hd
        ) * D
        return V * D * 2 + L * (attn + 3 * D * F)
