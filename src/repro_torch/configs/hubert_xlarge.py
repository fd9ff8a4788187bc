"""HuBERT-XLarge — encoder-only, wav2vec2 arch [arXiv:2106.07447].

The modality frontend (conv feature extractor) is a stub:
``batch["frames"]`` carries precomputed frame embeddings [B, T, d_model].
w2v2's conv positional embedding is stood in for by RoPE. Encoder-only:
``transformer.encode``, no decode.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504, input_mode="frames",
    causal=False,
)

SMOKE = ArchConfig(
    name="hubert-xlarge-smoke", family="encoder", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab=56, input_mode="frames",
    causal=False, head_dim=32,
)
