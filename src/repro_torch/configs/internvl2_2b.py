"""InternVL2-2B — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

The ViT frontend is a stub: ``batch["patches"]`` carries precomputed patch
embeddings [B, n_patches, d_model], concatenated as a prefix to the token
embeddings. The LM backbone (InternLM2-1.8B: GQA kv=8) is implemented in
full, the PackKV decode path included.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=8192, vocab=92553, head_dim=128,
    input_mode="tokens_patches", n_patches=256,
)

SMOKE = ArchConfig(
    name="internvl2-2b-smoke", family="vlm", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
    input_mode="tokens_patches", n_patches=16,
)
