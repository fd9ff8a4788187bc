"""RecurrentGemma-9B: RG-LRU recurrent blocks and local attention, 2:1
[arXiv:2402.19427]. PackKV compresses the local-attention layers'
sliding-window cache (window 2048, a ring buffer); the RG-LRU layers carry
O(1) state."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid_rglru", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000, head_dim=256,
    window=2048, rec_per_attn=2, lru_dim=4096,
)

SMOKE = ArchConfig(
    name="recurrentgemma-9b-smoke", family="hybrid_rglru", n_layers=5,
    d_model=128, n_heads=4, n_kv_heads=1, d_ff=256, vocab=512, head_dim=32,
    window=128, rec_per_attn=2, lru_dim=128,
)
