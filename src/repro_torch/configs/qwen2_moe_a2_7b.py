"""Qwen1.5-MoE-A2.7B — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=151936, n_experts=60, n_shared_experts=4,
    moe_topk=4, d_ff_expert=1408,
)

SMOKE = ArchConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=512, head_dim=32, n_experts=8,
    n_shared_experts=2, moe_topk=2, d_ff_expert=128,
)
