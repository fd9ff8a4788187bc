"""Qwen3-32B: qk-norm, GQA at G = 8, head dim 128 decoupled from d_model
[hf:Qwen]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense", n_layers=64, d_model=5120, n_heads=64,
    n_kv_heads=8, d_ff=25600, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen3-32b-smoke", family="dense", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=512, head_dim=32, qk_norm=True,
)
