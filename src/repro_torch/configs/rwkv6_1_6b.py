"""RWKV-6 "Finch" 1.6B: data-dependent decay, attention-free
[arXiv:2404.05892]. PackKV does not apply: the decode state is O(1) in the
context, so there is no KV cache to compress."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="rwkv6", n_layers=24, d_model=2048, n_heads=32,
    n_kv_heads=32, d_ff=7168, vocab=65536, wkv_heads=32,  # head size 64
)

SMOKE = ArchConfig(
    name="rwkv6-1.6b-smoke", family="rwkv6", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab=512, wkv_heads=4,
)
