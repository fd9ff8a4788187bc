"""Minitron-4B: a pruned Nemotron, GQA at G = 3 [arXiv:2407.14679; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b", family="dense", n_layers=32, d_model=3072, n_heads=24,
    n_kv_heads=8, d_ff=9216, vocab=256000, head_dim=128,
)

SMOKE = ArchConfig(
    name="minitron-4b-smoke", family="dense", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
)
