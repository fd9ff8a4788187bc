"""Moonlight-16B-A3B (kimi/moonshot) — 64 routed top-6
[hf:moonshotai/Moonlight-16B-A3B]. Moonlight additionally carries 2 shared
experts (DeepSeek-V3-style), configured here per the HF card.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163840, n_experts=64,
    n_shared_experts=2, moe_topk=6, d_ff_expert=1408,
)

SMOKE = ArchConfig(
    name="moonshot-v1-16b-a3b-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=512, head_dim=32, n_experts=8,
    n_shared_experts=1, moe_topk=3, d_ff_expert=128,
)
