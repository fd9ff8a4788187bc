"""MiniCPM-2B: a llama-like architecture with head dim 64 [arXiv:2404.06395;
hf], trained under the WSD (warmup-stable-decay) schedule of
``repro_torch.training.optimizer``, which ``TRAIN_SCHEDULE`` selects."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense", n_layers=40, d_model=2304, n_heads=36,
    n_kv_heads=36, d_ff=5760, vocab=122753,
)

SMOKE = ArchConfig(
    name="minicpm-2b-smoke", family="dense", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab=511,  # odd vocab keeps the padding path hot
)

TRAIN_SCHEDULE = "wsd"
