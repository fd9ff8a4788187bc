"""Architecture configuration schema (the torch port's copy of
``repro/configs/base.py``: every family's parameter counts; the shape
grid and the skip rules arrive with the ports that use them)."""
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
    rec_per_attn: int = 0  # recurrent blocks per attention block (2 for RG)
    conv_width: int = 4
    lru_dim: int = 0  # RG-LRU width (defaults to d_model)
    # rwkv
    wkv_heads: int = 0
    # io
    input_mode: str = "tokens"  # tokens | frames | tokens_patches
    n_patches: int = 256
    causal: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def has_decode(self) -> bool:
        return self.family != "encoder"

    def _attn_params(self) -> int:
        D, hd = self.d_model, self.hd
        return D * (self.n_heads * hd) + 2 * D * (self.n_kv_heads * hd) + (
            self.n_heads * hd
        ) * D

    def param_count(self) -> int:
        """Embed + untied head + layers; an MoE layer counts every routed
        and shared expert and its router; an rwkv6 layer its time mix
        (r, k, v, g, o) and channel mix; a hybrid model its attention
        blocks and its recurrent blocks (in, gate, the two LRU gates, out),
        each with its MLP, as the reference counts them."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = V * D * 2
        if self.family == "rwkv6":
            return emb + L * (6 * D * D + 2 * D * F)
        attn = self._attn_params()
        if self.family == "moe":
            moe = self.n_experts * 3 * D * self.d_ff_expert + D * self.n_experts
            shared = self.n_shared_experts * 3 * D * self.d_ff_expert
            return emb + L * (attn + moe + shared)
        if self.family == "hybrid_rglru":
            R = self.lru_dim or D
            rec = 2 * D * R + 2 * R * R + R * D
            n_attn = L // (self.rec_per_attn + 1)
            return emb + n_attn * (attn + 3 * D * F) + (L - n_attn) * (rec + 3 * D * F)
        return emb + L * (attn + 3 * D * F)

    def active_param_count(self) -> int:
        """Parameters one token runs through: an MoE layer's top-k and
        shared experts and its router."""
        if self.family != "moe":
            return self.param_count()
        D, L = self.d_model, self.n_layers
        active = (self.moe_topk + self.n_shared_experts) * 3 * D * self.d_ff_expert
        return self.vocab * D * 2 + L * (self._attn_params() + active
                                         + D * self.n_experts)
